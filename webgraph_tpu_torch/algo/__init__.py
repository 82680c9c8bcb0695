from webgraph_tpu_torch.algo.bfs import ParallelBreadthFirstVisit, bfs_distances
from webgraph_tpu_torch.algo.components import ConnectedComponents, StronglyConnectedComponents
from webgraph_tpu_torch.algo.hll import HyperLogLogCounterArray
from webgraph_tpu_torch.algo.hyperball import HyperBall
from webgraph_tpu_torch.algo.nf import NeighbourhoodFunction
from webgraph_tpu_torch.algo.sumsweep import SumSweepDirectedDiameterRadius, SumSweepUndirectedDiameterRadius
from webgraph_tpu_torch.algo.centralities import (
    GeometricCentralities,
    LinearGeometricCentrality,
    TopKGeometricCentrality,
    BetweennessCentrality,
    SampleDistanceCumulativeDistributionFunction,
)
