"""The single-shot capability forms, shared by the counterparts of the JAX
package's ``scripts/pallas_caps_probe.py``, ``pallas_bisect_probe.py``,
``pallas_bisect2.py`` and ``v6_probe.py``'s ``probe_ta0`` and ``probe_t8``
(:mod:`.caps`, :mod:`.bisect`, :mod:`.bisect2`, :mod:`.v6`).  Each TPU probe
asks whether one Mosaic form lowers and computes the right array; each family
here is one kernel of ``csrc/forms.cu`` that computes the same array:

* :func:`gather` (``probe_form_gather``): ``take_along_axis`` on axis 1 or
  0;
* :func:`relayout` (``probe_form_relayout``): transposes (into a column
  block of a zero array), reshapes and broadcasts;
* :func:`roll` (``probe_form_roll``): caps' per-row rotate by a network of
  rolls, bisect2's roll of whole rows by a device-held shift;
* :func:`dot` (``probe_form_dot``): int8 -> int32 products on the tensor
  cores, float32 and bf16 -> float32;
* :func:`onehot` (``probe_form_onehot``): the one-hot products (byte-plane
  scatter, row gathers, a float32 scatter-sum);
* :func:`copy` (``probe_form_copy``): copies at device-held offsets (TMA
  bulk copies);
* :func:`scalar` (``probe_form_scalar``): clz, and a counted loop with a
  conditional store.

bisect2's two loops run on :mod:`.loops`' ``probe_transpose_loop`` and
``probe_gather_loop``, as :class:`Form` s too.  Every wrapper returns a tuple whose first item is the script's output array.
CPU tensors take the plain version, which keeps the scripts' steps
(``torch.gather``, ``torch.roll``, the networks of rolls, one-hot products as
gathers or ``index_add_``); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses

import torch

from webgraph_tpu_torch.probes import (M32, check, device_ms, device_of, launch,
                                      parser, tensors)
from webgraph_tpu_torch.probes import loops
from webgraph_tpu_torch.probes.loops import UNWRITTEN, _done

FILL = -(1 << 31)  # jnp.take_along_axis's value for an index outside the table
ROW = 128          # words a row of the copied and one-hot arrays
SHIFTS = (0, 8, 16, 24)

# probe_form_relayout's modes
RL_TRANSPOSE, RL_COPY = 0, 1
# probe_form_roll's modes
RO_NET, RO_AXIS0 = 0, 1
# probe_form_dot's operand types
DOT_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
# probe_form_onehot's modes
OH_SCATTER, OH_GATHER_I8, OH_GATHER_PLANES, OH_GATHER_BF16, OH_SCATTER_SUM = range(5)
# probe_form_copy's modes: rows copied by a block
CP_DMA, CP_FLATTEN, CP_PREFETCH = 0, 1, 2
CP_ROWS = {CP_DMA: 256, CP_FLATTEN: 16, CP_PREFETCH: 8}
# probe_form_scalar's modes
SC_CLZ, SC_FORI = 0, 1
FORI_WHEN = 7  # the count at which the script's pl.when stores


def _i8(x):
    """int64 holding a byte -> its int8 value."""
    return torch.where(x >= 128, x - 256, x)


# ---------------------------------------------------------------- gather


def _take(tbl, idx, axis):
    """``jnp.take_along_axis``: an index below 0 counts from the end, one
    still outside gives :data:`FILL`."""
    n = tbl.shape[axis]
    k = torch.where(idx < 0, idx + n, idx)
    ok = (k >= 0) & (k < n)
    return torch.where(ok, torch.gather(tbl, axis, torch.where(ok, k, 0)), FILL)


def gather_plain(table, idx, axis: int = 1):
    """Plain version of :func:`gather`."""
    return _done(_take(table.long(), idx.long(), axis))


def gather(table, idx, axis: int = 1):
    """``table`` int32 (rows, cols) -> ``(out,)``, the script's
    ``take_along_axis(table, idx, axis)`` (``idx`` int32: (rows, k) on axis
    1, (k, cols) on axis 0), indices as in :func:`_take`.  CPU tensors take
    :func:`gather_plain`; CUDA tensors launch ``probe_form_gather``."""
    if table.device.type == "cpu":
        return gather_plain(table, idx, axis)
    dev = table.device
    rows, cols = table.shape
    check("gather", "table", table, torch.int32, (rows, cols), dev)
    check("gather", "idx", idx, torch.int32, tuple(idx.shape), dev)
    if idx.dim() != 2 or axis not in (0, 1) \
            or idx.shape[1 - axis] != table.shape[1 - axis]:
        raise ValueError(f"gather: idx {tuple(idx.shape)} does not match table "
                         f"{(rows, cols)} on axis {axis}")
    out = torch.empty(tuple(idx.shape), dtype=torch.int32, device=dev)
    launch(gather, "wgt_probe_form_gather", dev, table.data_ptr(), rows, cols,
           idx.data_ptr(), idx.shape[0], idx.shape[1], axis, out.data_ptr())
    return (out,)


gather.launches = 0


# ---------------------------------------------------------------- relayout


def relayout_plain(x, mode: int, shape=None, width=None, col: int = 0):
    """Plain version of :func:`relayout`."""
    if mode == RL_COPY:
        y = x.reshape(shape) if x.numel() == torch.Size(shape).numel() \
            else torch.broadcast_to(x, shape)
        return (y.contiguous(),)
    rows = x.shape[0]
    width = rows if width is None else width
    t = x.T
    if (col, width) != (0, rows):
        t = torch.nn.functional.pad(t, (col, width - col - rows))
    return (t.contiguous(),)


def relayout(x, mode: int, shape=None, width=None, col: int = 0):
    """``x`` int32 (R, C) -> ``(out,)``: :data:`RL_TRANSPOSE`, ``x.T``
    written into columns ``col .. col + R`` of a zero (C, ``width``) array
    (``width`` R by default: the transpose); :data:`RL_COPY`, ``x`` as
    ``shape`` in row-major order, a reshape, or a broadcast of a (1, W) row.
    CPU tensors take :func:`relayout_plain`; CUDA tensors launch
    ``probe_form_relayout``."""
    if x.device.type == "cpu":
        return relayout_plain(x, mode, shape, width, col)
    dev = x.device
    check("relayout", "x", x, torch.int32, tuple(x.shape), dev)
    if x.dim() != 2:
        raise ValueError("relayout: x must be a matrix")
    rows, cols = x.shape
    if mode == RL_COPY:
        n = torch.Size(shape).numel()
        if not (n == x.numel() or (rows == 1 and shape[-1] == cols)):
            raise ValueError(f"relayout: {tuple(x.shape)} neither reshapes nor "
                             f"broadcasts to {tuple(shape)}")
        out = torch.empty(tuple(shape), dtype=torch.int32, device=dev)
        launch(relayout, "wgt_probe_form_relayout", dev, x.data_ptr(), rows, cols,
               mode, 0, 0, n, out.data_ptr())
        return (out,)
    width = rows if width is None else width
    if mode != RL_TRANSPOSE or col < 0 or width < col + rows:
        raise ValueError(f"relayout: mode {mode} does not take {tuple(x.shape)} "
                         f"into width {width} at column {col}")
    out = torch.empty((cols, width), dtype=torch.int32, device=dev)
    launch(relayout, "wgt_probe_form_relayout", dev, x.data_ptr(), rows, cols, mode,
           width, col, 0, out.data_ptr())
    return (out,)


relayout.launches = 0


# ---------------------------------------------------------------- roll


def roll_plain(x, shift, mode: int):
    """Plain version of :func:`roll`: caps' network of ``roll(x, W - 2^b,
    1)`` under bit b of the shift, or ``torch.roll`` by the shift."""
    if mode == RO_AXIS0:
        return (torch.roll(x, int(shift.reshape(-1)[0]), 0),)
    w = x.shape[1]
    s = shift.long()
    for b in range(w.bit_length() - 1):
        x = torch.where(((s >> b) & 1) > 0, torch.roll(x, w - (1 << b), 1), x)
    return (x,)


def roll(x, shift, mode: int):
    """``x`` int32 (N, W) -> ``(out,)``: :data:`RO_NET` (caps), row i
    rotated left by ``shift[i] & (W - 1)`` (``shift`` int32 (N, 1), W a
    power of 2); :data:`RO_AXIS0` (bisect2), ``jnp.roll(x, shift[0], 0)``.
    The shifts stay in device memory.  CPU tensors take :func:`roll_plain`;
    CUDA tensors launch ``probe_form_roll``."""
    if x.device.type == "cpu":
        return roll_plain(x, shift, mode)
    dev = x.device
    rows, cols = x.shape
    check("roll", "x", x, torch.int32, (rows, cols), dev)
    want = (rows, 1) if mode == RO_NET else (1,)
    check("roll", "shift", shift, torch.int32, want, dev)
    if mode not in (RO_NET, RO_AXIS0) or (mode == RO_NET and cols & (cols - 1)):
        raise ValueError(f"roll: mode {mode} does not take width {cols}")
    out = torch.empty_like(x)
    launch(roll, "wgt_probe_form_roll", dev, x.data_ptr(), rows, cols,
           shift.data_ptr(), mode, out.data_ptr())
    return (out,)


roll.launches = 0


# ---------------------------------------------------------------- products


def dot_plain(a, b, trans_a: bool = False):
    """Plain version of :func:`dot`: the int8 product in float64 (exact;
    CUDA has no integer ``matmul``), the others in float32."""
    a = a.T if trans_a else a
    if b.dtype == torch.int8:
        return ((a.double() @ b.double()).long().to(torch.int32),)
    return (a.float() @ b.float(),)


def dot(a, b, trans_a: bool = False):
    """``a`` (m, k) (with ``trans_a``: (k, m), contracted on dim 0, as
    caps' ``dot_general``), ``b`` (k, n), both int8, float32 or bf16 ->
    ``(out (m, n),)``, int32 for int8 (sums on the tensor cores: m % 64, k
    % 32, n % 128 == 0), else float32 (FMAs in order of k: exact on the
    scripts' small integers).  CPU tensors take :func:`dot_plain`; CUDA
    tensors launch ``probe_form_dot``."""
    if b.device.type == "cpu":
        return dot_plain(a, b, trans_a)
    dev = b.device
    if b.dtype not in DOT_TYPES or b.dim() != 2 or a.dim() != 2:
        raise ValueError(f"dot: takes int8, float32 or bf16 matrices, got {b.dtype}")
    k, n = b.shape
    m = a.shape[1] if trans_a else a.shape[0]
    check("dot", "a", a, b.dtype, (k, m) if trans_a else (m, k), dev)
    check("dot", "b", b, b.dtype, (k, n), dev)
    i8 = b.dtype == torch.int8
    if i8 and (m % 64 or k % 32 or n % 128):
        raise ValueError(f"dot: int8 takes m % 64, k % 32, n % 128 == 0, got "
                         f"{(m, k, n)}")
    out = torch.empty((m, n), dtype=torch.int32 if i8 else torch.float32, device=dev)
    launch(dot, "wgt_probe_form_dot", dev, a.data_ptr(), b.data_ptr(), m, k, n,
           DOT_TYPES[b.dtype], int(bool(trans_a)), out.data_ptr())
    return (out,)


dot.launches = 0


# ---------------------------------------------------------------- one-hot products


def onehot_plain(src, idx, rows: int, mode: int):
    """Plain version of :func:`onehot`: each product as ``index_add_`` or a
    row gather, with the scripts' planes."""
    dev = src.device
    flat = idx.reshape(-1).long()
    if mode == OH_SCATTER_SUM:
        vals = src.reshape(-1).to(torch.bfloat16).float()
        ok = (flat >= 0) & (flat < rows)
        sums = torch.zeros(rows, dtype=torch.float32, device=dev)
        sums.index_add_(0, flat[ok], vals[ok])
        return (sums.to(torch.int32)[:, None].expand(rows, ROW).contiguous(),)
    ok = (flat >= 0) & (flat < rows)
    v = src.long()
    if mode == OH_SCATTER:
        acc = torch.zeros((rows, ROW), dtype=torch.int64, device=dev)
        for sh in SHIFTS:
            part = torch.zeros((rows, ROW), dtype=torch.int64, device=dev)
            part.index_add_(0, flat[ok], _i8((v[ok] >> sh) & 0xFF))
            acc += (part & 0xFF) << sh
        return _done(acc)
    got = v[torch.where(ok, flat, 0)]
    if mode == OH_GATHER_I8:
        acc = got
    elif mode == OH_GATHER_PLANES:
        acc = sum((_i8((got >> sh) & 0xFF) & 0xFF) << sh for sh in SHIFTS)
    else:
        acc = sum(((got >> sh) & 0xFF).to(torch.bfloat16).float().long() << sh
                  for sh in SHIFTS)
    return _done(torch.where(ok[:, None], acc, 0))


def onehot(src, idx, rows: int, mode: int):
    """The scripts' one-hot products in closed form -> ``(out,)`` int32:
    :data:`OH_SCATTER` (caps), ``src`` int32 (L, 128) scattered into
    ``rows`` rows by ``idx`` (L, 1) through four sign-extended int8 byte
    planes, each plane's sum masked to its byte and shifted back;
    :data:`OH_GATHER_I8` (bisect), row ``idx[l]`` of an int8 pool ``src``
    (rows, 128), sign-extended; :data:`OH_GATHER_PLANES` and
    :data:`OH_GATHER_BF16` (bisect2), row ``idx[l]`` of an int32 pool through
    its int8 or bf16 byte planes (a lane outside the pool gets 0);
    :data:`OH_SCATTER_SUM` (bisect2), ``src`` int32 (8, 128) rounded to bf16
    and summed in float32 into ``rows`` rows by ``idx``, each row's sum
    truncated and broadcast over 128 columns.  CPU tensors take
    :func:`onehot_plain`; CUDA tensors launch ``probe_form_onehot``."""
    if src.device.type == "cpu":
        return onehot_plain(src, idx, rows, mode)
    dev = src.device
    check("onehot", "idx", idx, torch.int32, tuple(idx.shape), dev)
    n = idx.numel()
    if mode == OH_SCATTER:
        check("onehot", "src", src, torch.int32, (n, ROW), dev)
    elif mode in (OH_GATHER_I8, OH_GATHER_PLANES, OH_GATHER_BF16):
        check("onehot", "src", src, torch.int8 if mode == OH_GATHER_I8 else torch.int32,
              (rows, ROW), dev)
    elif mode == OH_SCATTER_SUM:
        check("onehot", "src", src, torch.int32, tuple(idx.shape), dev)
        if n > 1024 or rows > 1024:
            raise ValueError("onehot: the scatter-sum takes at most 1,024 lanes and rows")
    else:
        raise ValueError(f"onehot: unknown mode {mode}")
    nout = n if mode in (OH_GATHER_I8, OH_GATHER_PLANES, OH_GATHER_BF16) else rows
    out = torch.empty((nout, ROW), dtype=torch.int32, device=dev)
    launch(onehot, "wgt_probe_form_onehot", dev, src.data_ptr(), idx.data_ptr(), n,
           rows, mode, out.data_ptr())
    return (out,)


onehot.launches = 0


# ---------------------------------------------------------------- copies


def _copy_shape(mode, src_rows, nblocks):
    return {CP_DMA: (src_rows, ROW), CP_FLATTEN: (8, src_rows * ROW),
            CP_PREFETCH: (8 * nblocks, ROW)}[mode]


def copies(src_rows: int, offs=None, mode: int = CP_DMA):
    """The copies :func:`copy` makes: ``(from, to)`` row pairs, each of
    :data:`CP_ROWS` rows (of 128 words: the flatten's output as rows), those
    whose rows fall inside both arrays."""
    nb = 1 if offs is None or mode != CP_PREFETCH else offs.numel()
    out_rows = _copy_shape(mode, src_rows, nb)
    out_rows = out_rows[0] * out_rows[1] // ROW
    n = CP_ROWS[mode]
    made = []
    for b in range(nb):
        if mode == CP_DMA:
            frm = int(offs.reshape(-1)[0])
            to = frm + 8
        elif mode == CP_PREFETCH:
            frm, to = int(offs.reshape(-1)[b]) * 8, 8 * b
        else:
            frm = to = 0
        if 0 <= frm and frm + n <= src_rows and 0 <= to and to + n <= out_rows:
            made.append((frm, to))
    return made


def copy_plain(src, offs=None, mode: int = CP_DMA):
    """Plain version of :func:`copy`: slices at the offsets, copied."""
    rows = src.shape[0]
    nb = 1 if offs is None or mode != CP_PREFETCH else offs.numel()
    out = torch.full(_copy_shape(mode, rows, nb), UNWRITTEN, dtype=torch.int64,
                     device=src.device)
    flat = out.reshape(-1, ROW)
    n = CP_ROWS[mode]
    for frm, to in copies(rows, offs, mode):
        part = src[frm:frm + n].long()
        flat[to:to + n] = {CP_DMA: part * 2, CP_PREFETCH: part + 1}.get(mode, part)
    return _done(out)


def copy(src, offs=None, mode: int = CP_DMA):
    """caps' copies at offsets held in device memory -> ``(out,)``, int32;
    words no copy writes hold ``loops.UNWRITTEN``.  :data:`CP_DMA`: ``src``
    (W, 128), ``offs`` (1,) the start: rows ``start .. + 256`` doubled into
    rows ``start + 8 ..`` of a (W, 128) output; :data:`CP_FLATTEN` (no
    ``offs``): ``src`` (16, 128)'s words in order into row 0 of (8, 2048);
    :data:`CP_PREFETCH`: ``offs`` (T,) row blocks, tile t = rows ``8
    offs[t] .. + 8`` of ``src``, plus 1, into rows ``8 t ..`` of (8 T, 128),
    a block a tile.  A copy whose rows fall outside either array is not
    made.  CPU tensors take :func:`copy_plain`; CUDA tensors launch
    ``probe_form_copy``."""
    if src.device.type == "cpu":
        return copy_plain(src, offs, mode)
    dev = src.device
    rows = src.shape[0]
    check("copy", "src", src, torch.int32, (rows, ROW), dev)
    if mode not in CP_ROWS or (mode == CP_FLATTEN) != (offs is None) \
            or (mode == CP_FLATTEN and rows != CP_ROWS[CP_FLATTEN]):
        raise ValueError(f"copy: mode {mode} does not take these operands")
    nb = 1
    if offs is not None:
        nb = offs.numel() if mode == CP_PREFETCH else 1
        check("copy", "offs", offs, torch.int32, (nb,), dev)
    out = torch.full(_copy_shape(mode, rows, nb), UNWRITTEN, dtype=torch.int32,
                     device=dev)
    launch(copy, "wgt_probe_form_copy", dev, src.data_ptr(), rows,
           None if offs is None else offs.data_ptr(), mode, nb, out.data_ptr(),
           out.numel() // ROW)
    return (out,)


copy.launches = 0


# ---------------------------------------------------------------- scalar forms


def scalar_plain(x, mode: int, trips: int = 0):
    """Plain version of :func:`scalar`: the leading zeros by halving, the
    loop step by step."""
    u = x.long() & M32
    if mode == SC_CLZ:
        bits = torch.zeros_like(u)
        for s in (16, 8, 4, 2, 1):
            hi = u >= (1 << s)
            bits += hi * s
            u = torch.where(hi, u >> s, u)
        return _done(32 - bits - (u > 0).long())
    a = torch.zeros_like(u)
    b = 0
    for _ in range(trips):
        a = a + u
        b += 1
    o = a if b == FORI_WHEN else torch.full_like(a, UNWRITTEN)
    return _done(o, torch.tensor([[b]], device=x.device))


def scalar(x, mode: int, trips: int = 0):
    """``x`` int32 -> :data:`SC_CLZ` (caps ``probe_clz``): ``(out,)``, the
    leading zeros of each word as uint32, 32 for 0; :data:`SC_FORI` (caps
    ``probe_fori``): ``(o, cnt (1, 1))``, ``trips`` adds of ``x`` and a
    count, ``o`` stored only where the count is 7 (``pl.when``; else
    ``loops.UNWRITTEN``).  CPU tensors take :func:`scalar_plain`; CUDA
    tensors launch ``probe_form_scalar``."""
    if x.device.type == "cpu":
        return scalar_plain(x, mode, trips)
    dev = x.device
    check("scalar", "x", x, torch.int32, tuple(x.shape), dev)
    if mode not in (SC_CLZ, SC_FORI) or trips < 0 or x.numel() < 1:
        raise ValueError(f"scalar: mode {mode}, trips {trips} not taken")
    out = torch.full(tuple(x.shape), UNWRITTEN, dtype=torch.int32, device=dev)
    cnt = torch.empty((1, 1), dtype=torch.int32, device=dev)
    launch(scalar, "wgt_probe_form_scalar", dev, x.data_ptr(), x.numel(), mode, trips,
           out.data_ptr(), cnt.data_ptr())
    return (out,) if mode == SC_CLZ else (out, cnt)


scalar.launches = 0

KERNELS = {"probe_form_gather": gather, "probe_form_relayout": relayout,
           "probe_form_roll": roll, "probe_form_dot": dot,
           "probe_form_onehot": onehot, "probe_form_copy": copy,
           "probe_form_scalar": scalar}
NAMES = {w: name for name, w in {**KERNELS, **loops.KERNELS}.items()}
PLAIN = {gather: gather_plain, relayout: relayout_plain, roll: roll_plain,
         dot: dot_plain, onehot: onehot_plain, copy: copy_plain,
         scalar: scalar_plain, **loops.PLAIN}


# ---------------------------------------------------------------- forms


@dataclasses.dataclass(frozen=True)
class Form:
    """One single-shot run of a script: its name, the wrapper it runs on,
    its numpy inputs in the order of the script's operands (``casts``: a
    torch dtype an input is cast to, e.g. bf16, or None), ``consts``: numpy
    inputs the script builds inside its kernel (bisect2's carry from ones),
    after them, the wrapper's other arguments, ``order`` (the wrapper's
    positional arguments as indices into the inputs; all of them in order
    by default), and ``expect``: the script's own check of the numpy
    outputs, or None where it has none."""

    name: str
    kernel: object
    arrays: tuple
    params: dict
    expect: object = None
    casts: tuple = ()
    order: tuple | None = None
    consts: tuple = ()

    def tensors(self, dev):
        return tensors(self.arrays + self.consts, self.casts, dev)

    def call(self, args, plain=False):
        """The wrapper (or its plain version) on ``args`` (:meth:`tensors`):
        a tuple whose first item is the script's output."""
        fn = PLAIN[self.kernel] if plain else self.kernel
        pos = args if self.order is None else [args[i] for i in self.order]
        return fn(*pos, **self.params)


def run_forms(forms, device="cuda"):
    """Each form on ``device``: ``{name: {"out", "ok", "ms", "kernel"}}``,
    ``ok`` the script's check of the output (None where it has none), ``ms``
    its :func:`probes.device_ms` (None on the CPU)."""
    dev = device_of(device)
    res = {}
    for f in forms:
        args = f.tensors(dev)
        out = f.call(args)
        ok = None if f.expect is None else bool(f.expect(*[o.cpu().numpy() for o in out]))
        res[f.name] = {"out": out, "ok": ok, "ms": device_ms(dev, lambda: f.call(args)),
                       "kernel": NAMES[f.kernel]}
    return res


def print_forms(res):
    for name, r in res.items():
        ok = {True: "ok", False: "WRONG", None: "no check"}[r["ok"]]
        ms = "not timed (cpu)" if r["ms"] is None else f"{r['ms']:.4f} ms"
        print(f"{name:14s} {r['kernel']:20s} {ok:8s} {ms}")


def main_for(module, argv=None):
    """The form probes' command line for ``module``: ``--device`` (default
    ``cuda``); prints a line a form and returns 1 if a check failed."""
    args = parser(module.__doc__).parse_args(argv)
    print(f"device={args.device}")
    res = run_forms(module.forms(), args.device)
    print_forms(res)
    return int(any(r["ok"] is False for r in res.values()))
