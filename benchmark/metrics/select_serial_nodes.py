"""select_serial_nodes: the nodes that ``enc_select``'s serial walk ran
again in an ``encode`` call, after repair rounds that stopped settling
(the port's ``select_serial_nodes`` count on ``encode.read_totals``; zero
on the CPU, whose plain selection runs no walk), the mean over the traced
window's calls (a program counter)."""

from benchmark.spans import count_per_call


def read(run):
    if run.op != "encode" or not run.spans:
        return None
    return count_per_call(run.spans, "encode.read_totals",
                          "select_serial_nodes")
