"""The port's hand-written CUDA kernels: wrappers and plain versions.

The kernels (``LAUNCHES`` key: wrapper, source in ``csrc/``, conv variant):

- ``conv2d``: :func:`conv2d_bias_relu`, ``conv2d.cu``, vcol (with the hpool
  epilogue and k_block);
- ``conv_taps``: :func:`conv_taps` (on the packed operands:
  :func:`conv_taps_packed`), ``conv_taps.cu``, taps (hpool, k_block);
- ``conv_pairs``: :func:`conv_pairs` (the launch on the packed operands:
  :func:`conv_pairs_packed`), ``conv_pairs.cu``, pairs;
- ``conv_im2col``: :func:`conv_im2col` (on the packed operands:
  :func:`conv_im2col_packed`), ``conv_im2col.cu``, fused;
- ``conv_g8``: :func:`conv_g8` (on the packed operands:
  :func:`conv_g8_packed`), ``conv_g8.cu``, g8 (stride >= 2);
- ``maxpool2d``: :func:`maxpool2d` and its W-only stage :func:`maxpool2d_w`,
  ``maxpool.cu``, the sep2 pool;
- ``maxpool_phases``: :func:`maxpool_phases` (the launch on the packed
  stack: :func:`maxpool_phases_packed`), ``maxpool_phases.cu``, the phases
  pool, after ``pool_phases_pack``: :func:`pool_phases_pack`, the same
  file's one-pass pack of its stack;
- ``maxpool_s2d``: :func:`maxpool_s2d` (the launch on the packed operand:
  :func:`maxpool_s2d_packed`), ``maxpool_s2d.cu``, the space-to-depth pool
  of the pool A/B (``pool_ab.py``'s ``s2d128``; no model path calls it),
  after ``s2d_pool_pack``: :func:`s2d_pool_pack`, the same file's one-pass
  pad and repack;
- ``lrn``: :func:`lrn`, ``lrn.cu``;
- ``conv_block``: :func:`conv_block`, ``conv_block.cu``, fuse="block";
- ``relu``: :func:`relu`, ``relu.cu``, the standalone ReLU (no path calls
  it; the convs fuse theirs);
- ``flash_fwd``: :func:`flash_fwd`, ``flash_fwd.cu``, the flash-attention
  forward behind ``ops/flash_attention.py``;
- ``flash_dq``, ``flash_dkv``: :func:`flash_dq`, :func:`flash_dkv`,
  ``flash_dq.cu`` and ``flash_dkv.cu``, its backward. The three run every
  head dim over ``flash_bwd_sm90.cuh`` (at D >= 256 its ``wide`` pieces).

The six conv kernels are implicit GEMMs on one Hopper mainloop,
``csrc/conv_sm90.cuh`` (fp32 on FFMA, bf16 and int8w on the tensor cores).
Each kernel has:

- a wrapper that checks device, dtype, shape and contiguity, packs the
  operands its variant reads (``ops/packing.py``), allocates its output
  with ``torch.empty`` and launches on the current stream without
  synchronising. A CUDA tensor goes to the kernel or the wrapper raises; a
  CPU tensor goes to the plain version, and only because it lies on the
  CPU. Each launch adds one to ``LAUNCHES[<kernel>]``, and
  :func:`reset_launches` sets every count to 0;
- a plain PyTorch version (``*_plain``) that repeats the kernel's
  arithmetic: the CPU path, and the yardstick ``chip_smoke.py`` holds each
  kernel against on the card.

Dtypes: fp32, or bf16 operands with fp32 accumulation (``conv_block``
also takes int8w: bf16 activations, int8 weights, fp32 scale and bias);
every kernel computes in fp32 and casts once at each store. Sources in ``csrc/``; the
bound, the TPU kernel replaced and the design are in each source's header
and summarised per wrapper below.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, packing, variants
from .attention import NEG_INF
from .shapes import conv_out_dim, pool_out_dim

# Kernel launches since the last reset: a plain integer per kernel. A CUDA
# graph's replay adds the launches its capture recorded (utils.cuda_graphs).
LAUNCHES = {
    "conv2d": 0, "maxpool2d": 0, "lrn": 0, "conv_block": 0,
    "conv_taps": 0, "conv_pairs": 0, "conv_im2col": 0, "conv_g8": 0, "pool_phases_pack": 0, "maxpool_phases": 0,
    "s2d_pool_pack": 0, "maxpool_s2d": 0, "relu": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Pooled output rows per block of the conv_block kernel (a band): the 3/2
# pool window shares one conv row between bands, computed twice.
CONV_BLOCK_BAND = 7


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype not in _SUFFIX or t.dtype != first.dtype:
            raise TypeError(f"{name}: needs all fp32 or all bf16, got {[u.dtype for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first.device


def _launch(kernel: str, entry: str, x: torch.Tensor, *args, suffix: str = "") -> None:
    """Call the library's ``<entry>_<suffix>`` (by default ``x``'s dtype) on
    the current stream of ``x``'s device, raise on a launch error, count
    the launch."""
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn = getattr(lib, f"{entry}_{suffix or _SUFFIX[x.dtype]}")
        _build.check(lib, fn(*args, stream), entry)
    LAUNCHES[kernel] += 1


def _window(x: torch.Tensor, fy: int, fx: int, stride: int, ho: int, wo: int) -> torch.Tensor:
    """The NHWC input pixels that tap (fy, fx) reads for every output."""
    return x[:, fy : fy + stride * (ho - 1) + 1 : stride, fx : fx + stride * (wo - 1) + 1 : stride, :]


# --------------------------------------------------------------------- conv


K_BLOCKS = (0, 64, 128)


def effective_k_block(k_block: int, k: int) -> int:
    """``variants.effective_k_block`` for a k_block the kernels take (0, 64
    or 128 output channels a block); raises for another."""
    if k_block not in K_BLOCKS:
        raise ValueError(f"k_block must be one of {K_BLOCKS}, got {k_block}")
    return variants.effective_k_block(k_block, k)


def _conv_geometry(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int):
    """Check a conv's operands; return ``(device, (n, h, wd, c, f, k, ho, wo))``."""
    dev = _check(name, x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit NHWC/HWIO")
    if b.shape != (w.shape[3],):
        raise ValueError(f"{name}: bias {tuple(b.shape)} for {w.shape[3]} channels")
    n, h, wd, c = x.shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    if min(n, ho, wo, k) <= 0:
        raise ValueError(f"{name}: empty output for x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), n * ho * wo * k, f * f * c * k) >= 2**31:
        raise ValueError(f"{name}: tensors past 2^31 elements")
    return dev, (n, h, wd, c, f, k, ho, wo)


# conv_sm90.cuh's MAX_DIM: the mainloop packs a window's origin into two 16-bit halves
SM90_MAX_DIM = 1 << 14


def _check_sm90_dims(name: str, h: int, wd: int, padding: int) -> None:
    """Raise where the CUDA conv mainloop refuses the image (the CPU runs any)."""
    if max(h, wd, padding) >= SM90_MAX_DIM:
        raise ValueError(f"{name}: H, W and padding must stay below {SM90_MAX_DIM} on CUDA, "
                         f"got {h}, {wd}, {padding}")


def _hpool_dims(name: str, ho: int, hpool, k_block: int, n: int):
    """``(pw, ps, hp)`` of an hpool epilogue ((0, 0, 0) without one)."""
    if hpool is None:
        return 0, 0, 0
    pw, ps = hpool
    hp = pool_out_dim(ho, pw, ps)
    if hp <= 0:
        raise ValueError(f"{name}: no {pw}/{ps} pool window fits {ho} conv rows")
    if k_block:
        raise ValueError(f"{name}: the hpool epilogue does not compose with k_block; unset one of them")
    if n > 65535:
        raise ValueError(f"{name}: the hpool epilogue takes a batch of at most 65535")
    return pw, ps, hp


def _epilogue_plain(acc: torch.Tensor, b: torch.Tensor, relu: bool, dtype: torch.dtype, hpool) -> torch.Tensor:
    """The conv epilogue on an fp32 accumulator: fp32 bias, ReLU, one cast,
    then (``hpool``) the H-axis max of the pool in tap order."""
    out = acc + b.float()
    if relu:
        out = relu_plain(out)
    out = out.to(dtype)
    return out if hpool is None else maxpool_rect_plain(out, window=(hpool[0], 1), stride=(hpool[1], 1))


def _conv_acc_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int, padding: int) -> torch.Tensor:
    """The conv's fp32 accumulator (N, Ho, Wo, K): tap by tap over (fy, fx),
    each tap one (pixels, C) x (C, K) matmul on fp32 copies of the operands
    (exact for fp32, bf16 and int8 values)."""
    n, h, wd, _c = x.shape
    f, k = w.shape[0], w.shape[3]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    xf = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    wf = w.float()
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=x.device)
    for fy in range(f):
        for fx in range(f):
            acc.addmm_(_window(xf, fy, fx, stride, ho, wo).reshape(n * ho * wo, -1), wf[fy, fx])
    return acc.reshape(n, ho, wo, k)


def conv2d_bias_relu_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Plain version of the vcol conv kernel: the fp32 accumulator, then the
    fp32 bias, ReLU and one cast to ``x.dtype`` (then the hpool H max).
    ``k_block`` changes no value."""
    return _epilogue_plain(_conv_acc_plain(x, w, stride=stride, padding=padding), b, relu, x.dtype, hpool)


def conv2d_bias_relu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Direct conv (cross-correlation) + bias + optional ReLU: the vcol body.

    ``x`` (N, H, W, C), ``w`` (F, F, C, K) HWIO, ``b`` (K,), all fp32 or
    all bf16 -> (N, Ho, Wo, K) in the same dtype. ``k_block`` (0, 64, 128):
    output channels per block where it applies (:func:`effective_k_block`),
    bitwise the unblocked result. ``hpool=(window, stride)``: also take the
    pool's H-axis max, -> (N, Hp, Wo, K); :func:`maxpool2d_w` finishes it.

    Replaces ``_conv_vcol_kernel`` with ``_conv_epilogue``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: operations (conv1 27 GFLOP, conv2 115 GFLOP at batch 128):
    FFMA in fp32 (TF32 is out by the fp32 contract), the tensor cores in
    bf16. Design (``csrc/conv2d.cu`` on the Hopper mainloop of
    ``csrc/conv_sm90.cuh``): an implicit GEMM over 128 x 128 (pixels x
    channels) tiles, 32-term slices in a cp.async ring, the pixels gathered
    channel-major in 16-byte runs; fp32 one fmaf chain per output in the
    fixed (fy, fx, c) order, bf16 ``mma.sync`` steps in the same order; the
    bias/ReLU/cast (and hpool) epilogue fused."""
    dev, (n, h, wd, c, f, k, ho, wo) = _conv_geometry("conv2d_bias_relu", x, w, b, stride, padding)
    kb = effective_k_block(k_block, k)
    pw, ps, hp = _hpool_dims("conv2d_bias_relu", ho, hpool, kb, n)
    if dev.type == "cpu":
        return conv2d_bias_relu_plain(x, w, b, stride=stride, padding=padding, relu=relu, hpool=hpool)
    _check_sm90_dims("conv2d_bias_relu", h, wd, padding)
    y = torch.empty((n, hp if pw else ho, wo, k), dtype=x.dtype, device=dev)
    _launch(
        "conv2d", "conv2d_bias_relu", x, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, h, wd, c, k, f, stride, padding, ho, wo, int(relu), kb, pw, ps, hp,
    )
    return y


def _s2d_operands(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """The taps/pairs/fused operands: ``(xs, ws, fq, ho, wo)`` with xs
    (N, ho+fq-1, wo+fq-1, s*s*C) and ws (fq, fq, s*s*C, K), contiguous."""
    f = w.shape[0]
    fq = -(-f // stride)
    ho = conv_out_dim(x.shape[1], f, padding, stride)
    wo = conv_out_dim(x.shape[2], f, padding, stride)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    xs = packing.space_to_depth(x, stride, ho + fq - 1, wo + fq - 1).contiguous()
    return xs, packing.weights_to_depth(w, stride, fq).contiguous(), fq, ho, wo


def conv_taps_packed_plain(
    xs: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, *, ho: int, wo: int, relu: bool = True, hpool=None,
) -> torch.Tensor:
    """Plain version of the taps kernel on its operands as
    :func:`_s2d_operands` packs them: one (pixels, s*s*C) x (s*s*C, K)
    matmul per tap (qh, qw) in that order into an fp32 accumulator, then the
    epilogue."""
    n, cs, fq, k = xs.shape[0], xs.shape[3], ws.shape[0], ws.shape[3]
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=xs.device)
    for qh in range(fq):
        for qw in range(fq):
            acc.addmm_(xs[:, qh : qh + ho, qw : qw + wo, :].float().reshape(-1, cs), ws[qh, qw].float())
    return _epilogue_plain(acc.reshape(n, ho, wo, k), b, relu, xs.dtype, hpool)


def conv_taps_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Plain version of the taps kernel: the wrapper's operands, then
    :func:`conv_taps_packed_plain`. ``k_block`` changes no value."""
    xs, ws, _fq, ho, wo = _s2d_operands(x, w, stride, padding)
    return conv_taps_packed_plain(xs, ws, b, ho=ho, wo=wo, relu=relu, hpool=hpool)


def _packed_conv_dims(name: str, xs: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, k: int, ho: int, wo: int):
    """Check that ``xs`` (N, Hs, Ws, cs) and ``ws`` (fq, fq, cs, cols) make
    a stride-1 unpadded conv to ``ho`` x ``wo`` pixels with a ``k``-channel
    bias; return ``(n, fq)``."""
    fits = xs.dim() == 4 and ws.dim() == 4 and b.shape == (k,) and min(ho, wo, k) > 0
    fq = ws.shape[0] if fits else 0
    if (not fits or tuple(ws.shape[:3]) != (fq, fq, xs.shape[3])
            or xs.shape[1] < ho + fq - 1 or xs.shape[2] < wo + fq - 1):
        raise ValueError(f"{name}: xs {tuple(xs.shape)}, w {tuple(ws.shape)} and bias {tuple(b.shape)} "
                         f"do not make a conv to {ho}x{wo}x{k}")
    return xs.shape[0], fq


def _check_packed_cuda(name: str, xs: torch.Tensor, out_elems: int) -> None:
    """Raise where the CUDA mainloop refuses a packed input: past 2^31
    elements, or an Hs x Ws image past its 16-bit origins."""
    if max(xs.numel(), out_elems) >= 2**31:
        raise ValueError(f"{name}: a packed input of {tuple(xs.shape)} is past 2^31 elements")
    _check_sm90_dims(name, xs.shape[1], xs.shape[2], 0)


def conv_taps_packed(
    xs: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, *, ho: int, wo: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """The taps kernel alone, on ``xs`` (N, Hs, Ws, s*s*C) and ``ws`` (fq,
    fq, s*s*C, K) as :func:`_s2d_operands` packs them: (N, ho, wo, K) in
    xs's dtype; ``k_block`` and ``hpool`` as :func:`conv2d_bias_relu`. A CPU
    tensor runs :func:`conv_taps_packed_plain`."""
    dev = _check("conv_taps", xs, ws, b)
    k = ws.shape[-1]
    n, fq = _packed_conv_dims("conv_taps", xs, ws, b, k, ho, wo)
    kb = effective_k_block(k_block, k)
    pw, ps, hp = _hpool_dims("conv_taps", ho, hpool, kb, n)
    if dev.type == "cpu":
        return conv_taps_packed_plain(xs, ws, b, ho=ho, wo=wo, relu=relu, hpool=hpool)
    _check_packed_cuda("conv_taps", xs, n * ho * wo * k)
    y = torch.empty((n, hp if pw else ho, wo, k), dtype=xs.dtype, device=dev)
    _launch(
        "conv_taps", "conv_taps", xs, xs.data_ptr(), ws.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, xs.shape[1], xs.shape[2], xs.shape[3], k, fq, ho, wo, int(relu), kb, pw, ps, hp,
    )
    return y


def conv_taps(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
    k_block: int = 0, hpool=None,
) -> torch.Tensor:
    """Space-to-depth conv + bias + optional ReLU: the taps body. Arguments
    and result as :func:`conv2d_bias_relu` (``k_block``, ``hpool`` too).

    Replaces ``_conv_kernel`` with ``_conv_epilogue``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: operations (conv1 32 GFLOP with the zero taps past F, conv2
    115 GFLOP at batch 128): FFMA in fp32, the tensor cores in bf16. Design
    (``csrc/conv_taps.cu`` on the Hopper mainloop of ``csrc/conv_sm90.cuh``):
    the s2d operands packed here (``ops/packing.py``), then
    :func:`conv_taps_packed`: a stride-1 unpadded conv of xs with the
    weights ws, in the fixed (qh, qw, channel) order, which is im2col's term
    order (in both dtypes the bits of :func:`conv_pairs` and
    :func:`conv_im2col`, and at stride 1 of :func:`conv2d_bias_relu`)."""
    _conv_geometry("conv_taps", x, w, b, stride, padding)
    xs, ws, _fq, ho, wo = _s2d_operands(x, w, stride, padding)
    return conv_taps_packed(xs, ws, b, ho=ho, wo=wo, relu=relu, k_block=k_block, hpool=hpool)


def _pairs_operands(xs: torch.Tensor, ws: torch.Tensor, fq: int):
    """``(xpair, wpair, xs or None, wlast or None)``: column j's and j+1's
    channels side by side, and the matching taps stacked; the leftover
    operands only for odd fq."""
    xpair = torch.cat([xs[:, :, :-1, :], xs[:, :, 1:, :]], dim=-1).contiguous()
    m = fq // 2
    wpair = torch.cat([ws[:, 0 : 2 * m : 2], ws[:, 1 : 2 * m : 2]], dim=2).contiguous()
    if fq % 2:
        return xpair, wpair, xs, ws[:, fq - 1].contiguous()
    return xpair, wpair, None, None


def conv_pairs_packed_plain(
    xpair: torch.Tensor, wpair: torch.Tensor, xs, wlast, b: torch.Tensor, *, ho: int, wo: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the pairs kernel on its operands as
    :func:`_pairs_operands` packs them: per qh, one (pixels, 2*cs) x
    (2*cs, K) matmul per pair of taps left to right, then the leftover tap
    (odd fq: ``xs`` and ``wlast``; even fq: both None), into an fp32
    accumulator; then the epilogue."""
    n, fq, k = xpair.shape[0], wpair.shape[0], wpair.shape[-1]
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=xpair.device)
    for qh in range(fq):
        for p in range(fq // 2):
            win = xpair[:, qh : qh + ho, 2 * p : 2 * p + wo, :]
            acc.addmm_(win.float().reshape(n * ho * wo, -1), wpair[qh, p].float())
        if xs is not None:
            win = xs[:, qh : qh + ho, fq - 1 : fq - 1 + wo, :]
            acc.addmm_(win.float().reshape(n * ho * wo, -1), wlast[qh].float())
    return _epilogue_plain(acc.reshape(n, ho, wo, k), b, relu, xpair.dtype, None)


def conv_pairs_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the pairs kernel: the wrapper's operands, then
    :func:`conv_pairs_packed_plain`."""
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    return conv_pairs_packed_plain(*_pairs_operands(xs, ws, fq), b, ho=ho, wo=wo, relu=relu)


def conv_pairs_packed(
    xpair: torch.Tensor, wpair: torch.Tensor, xs, wlast, b: torch.Tensor, *, ho: int, wo: int, relu: bool = True,
) -> torch.Tensor:
    """The pairs kernel alone, on operands :func:`_pairs_operands` packed
    (``xs`` and ``wlast`` None for even fq): (N, ho, wo, K) in xpair's
    dtype. A CPU tensor runs :func:`conv_pairs_packed_plain`."""
    dev = _check("conv_pairs", *(t for t in (xpair, wpair, xs, wlast, b) if t is not None))
    n, hs, ws1, cs2 = xpair.shape
    fq, m, _, k = wpair.shape
    cs = cs2 // 2
    # odd fq: the leftover tap's xs (N, Hs, Ws, cs) and wlast (fq, cs, K); even fq: neither
    leftover = ((n, hs, ws1 + 1, cs), (fq, cs, k)) if fq % 2 else (None, None)
    shapes = [None if t is None else tuple(t.shape) for t in (xpair, wpair, xs, wlast)]
    fits = fq >= 2 and m == fq // 2 and wpair.shape[2] == cs2 and b.shape == (k,) and min(ho, wo) > 0
    if not fits or hs < ho + fq - 1 or ws1 + 1 < wo + fq - 1 or tuple(shapes[2:]) != leftover:
        raise ValueError(f"conv_pairs: operands {shapes} do not make a pairs conv to {ho}x{wo}x{k}")
    if dev.type == "cpu":
        return conv_pairs_packed_plain(xpair, wpair, xs, wlast, b, ho=ho, wo=wo, relu=relu)
    if max(xpair.numel(), 0 if xs is None else xs.numel(), n * ho * wo * k) >= 2**31:
        raise ValueError(f"conv_pairs: operands past 2^31 elements ({tuple(xpair.shape)})")
    y = torch.empty((n, ho, wo, k), dtype=xpair.dtype, device=dev)
    _launch(
        "conv_pairs", "conv_pairs", xpair, xpair.data_ptr(), None if xs is None else xs.data_ptr(),
        wpair.data_ptr(), None if wlast is None else wlast.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, hs, ws1 + 1, cs, k, fq, ho, wo, int(relu),
    )
    return y


def conv_pairs(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Paired-tap conv + bias + optional ReLU: the pairs body, for fq =
    ceil(F/stride) >= 2 (at fq = 1 there is nothing to pair: the caller
    runs taps, as the JAX package does). Arguments and result as
    :func:`conv2d_bias_relu` without ``k_block``/``hpool``.

    Replaces ``_conv_pairs_kernel`` and ``_conv_pairs_even_kernel``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py). Bound on
    the H100: operations, as :func:`conv2d_bias_relu`. Design
    (``csrc/conv_pairs.cu`` on the Hopper mainloop of
    ``csrc/conv_sm90.cuh``): the pair operands packed here at 2x the input
    bytes (xpair, wpair; xs and wlast for the odd leftover tap, absent for
    even fq), then :func:`conv_pairs_packed`: the mainloop's implicit GEMM
    with a pairs gather, in the order qh, pairs left to right, leftover,
    which is im2col's term order (the same bits as :func:`conv_im2col`)."""
    dev, (n, _h, _wd, _c, f, k, ho, wo) = _conv_geometry("conv_pairs", x, w, b, stride, padding)
    if -(-f // stride) < 2:
        raise ValueError(f"conv_pairs: nothing to pair at F={f}, stride={stride} (fq=1); run taps")
    if dev.type == "cpu":
        return conv_pairs_plain(x, w, b, stride=stride, padding=padding, relu=relu)
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    return conv_pairs_packed(*_pairs_operands(xs, ws, fq), b, ho=ho, wo=wo, relu=relu)


def _im2col_operands(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """``(xcol, wmat, ho, wo)``: the s2d windows of every tap (qh, qw)
    concatenated on the channel axis, (N*ho*wo, fq*fq*s*s*C), and the s2d
    weights as a (fq*fq*s*s*C, K) matrix."""
    xs, ws, fq, ho, wo = _s2d_operands(x, w, stride, padding)
    wins = [xs[:, qh : qh + ho, qw : qw + wo, :] for qh in range(fq) for qw in range(fq)]
    xcol = torch.cat(wins, dim=-1).reshape(-1, fq * fq * xs.shape[3])
    return xcol, ws.reshape(-1, w.shape[3]), ho, wo


def conv_im2col_packed_plain(
    xcol: torch.Tensor, wmat: torch.Tensor, b: torch.Tensor, *, n: int, ho: int, wo: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the im2col kernel on its operands: one (pixels, KD)
    x (KD, K) matmul into an fp32 accumulator, then the epilogue."""
    acc = torch.zeros((xcol.shape[0], wmat.shape[1]), dtype=torch.float32, device=xcol.device)
    acc.addmm_(xcol.float(), wmat.float())
    return _epilogue_plain(acc.reshape(n, ho, wo, -1), b, relu, xcol.dtype, None)


def conv_im2col_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the im2col kernel: the wrapper's operands, then
    :func:`conv_im2col_packed_plain`."""
    xcol, wmat, ho, wo = _im2col_operands(x, w, stride, padding)
    return conv_im2col_packed_plain(xcol, wmat, b, n=x.shape[0], ho=ho, wo=wo, relu=relu)


def conv_im2col_packed(
    xcol: torch.Tensor, wmat: torch.Tensor, b: torch.Tensor, *, n: int, ho: int, wo: int, relu: bool = True,
) -> torch.Tensor:
    """The im2col kernel alone, on ``xcol`` (n*ho*wo, KD) and ``wmat``
    (KD, K) as :func:`_im2col_operands` builds them: (n, ho, wo, K) in
    xcol's dtype. A CPU tensor runs :func:`conv_im2col_packed_plain`."""
    dev = _check("conv_im2col", xcol, wmat, b)
    k = wmat.shape[1] if wmat.dim() == 2 else 0
    if (xcol.dim() != 2 or wmat.dim() != 2 or xcol.shape != (n * ho * wo, wmat.shape[0]) or b.shape != (k,)
            or min(n, ho, wo, k) <= 0):
        raise ValueError(f"conv_im2col: xcol {tuple(xcol.shape)}, w {tuple(wmat.shape)} and bias "
                         f"{tuple(b.shape)} do not make an im2col GEMM to {n}x{ho}x{wo}")
    if dev.type == "cpu":
        return conv_im2col_packed_plain(xcol, wmat, b, n=n, ho=ho, wo=wo, relu=relu)
    if max(xcol.numel(), n * ho * wo * k) >= 2**31:
        raise ValueError(f"conv_im2col: an im2col buffer of {tuple(xcol.shape)} is past 2^31 elements")
    # the mainloop sees xcol as a 1 x 1 conv over an n x ho x wo image: its origins' 16-bit halves
    _check_sm90_dims("conv_im2col", ho, wo, 0)
    y = torch.empty((n, ho, wo, k), dtype=xcol.dtype, device=dev)
    _launch(
        "conv_im2col", "conv_im2col", xcol, xcol.data_ptr(), wmat.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, ho, wo, xcol.shape[1], k, int(relu),
    )
    return y


def conv_im2col(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """im2col + one GEMM + bias + optional ReLU: the fused body. Arguments
    and result as :func:`conv2d_bias_relu` without ``k_block``/``hpool``.

    Replaces ``_conv_fused_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/
    ops/pallas_kernels.py). Bound on the H100: operations, as
    :func:`conv2d_bias_relu` (the xcol buffer, 0.67 GB on conv1 and 0.90 GB
    on conv2 in fp32 at batch 128, adds bytes but not the bound). Design
    (``csrc/conv_im2col.cu`` on the Hopper mainloop of
    ``csrc/conv_sm90.cuh``): xcol built here with tensor code, as the JAX
    package does, then :func:`conv_im2col_packed`: the (M, KD) x (KD, K)
    GEMM as a 1 x 1 conv with the shared epilogue."""
    dev, (n, _h, _wd, _c, _f, _k, ho, wo) = _conv_geometry("conv_im2col", x, w, b, stride, padding)
    if dev.type == "cpu":
        return conv_im2col_plain(x, w, b, stride=stride, padding=padding, relu=relu)
    xcol, wmat, ho, wo = _im2col_operands(x, w, stride, padding)
    return conv_im2col_packed(xcol, wmat, b, n=n, ho=ho, wo=wo, relu=relu)


def _g8_phase_columns(w8: torch.Tensor) -> torch.Tensor:
    """The four phase weight frames of ``w8`` (2, 2, fq8, fq8, G, K) side
    by side, (fq8, fq8, G, 4K): column (2*ph + pw)*K + ch is phase (ph,
    pw)'s channel ch, the weights of one conv whose 4K columns are the
    output phases."""
    _, _, fq8, _, gch, k = w8.shape
    return w8.permute(2, 3, 4, 0, 1, 5).reshape(fq8, fq8, gch, 4 * k).contiguous()


def _g8_operands(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """The g8 operands: ``(xs8, wcols, ho, wo)`` with xs8 (N, ho2+fq8-1,
    wo2+fq8-1, g*g*C) packed at g = 2*stride, ho2 = ceil(ho/2), and wcols
    the phase columns (:func:`_g8_phase_columns`) of the phase weight
    frames, fq8 = ceil((F+stride)/g), contiguous."""
    f, s = w.shape[0], stride
    g = 2 * s
    fq8 = -(-(f + s) // g)
    ho = conv_out_dim(x.shape[1], f, padding, s)
    wo = conv_out_dim(x.shape[2], f, padding, s)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    xs8 = packing.space_to_depth(x, g, -(-ho // 2) + fq8 - 1, -(-wo // 2) + fq8 - 1).contiguous()
    return xs8, _g8_phase_columns(packing.weights_to_phase_depth(w, s, g, fq8)), ho, wo


def conv_g8_packed_plain(
    xs8: torch.Tensor, wcols: torch.Tensor, b: torch.Tensor, *, ho: int, wo: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the g8 kernel on its operands as
    :func:`_g8_operands` packs them: one (phase pixels, g*g*C) x (g*g*C,
    4K) matmul per tap (qh, qw) into an fp32 accumulator, column
    (2*ph + pw)*K + ch of phase pixel (n, a, b) to output pixel
    (n, 2a + ph, 2b + pw), channel ch, cropped to ho x wo; then the
    epilogue."""
    n, gch, fq8, k = xs8.shape[0], xs8.shape[3], wcols.shape[0], wcols.shape[3] // 4
    ho2, wo2 = -(-ho // 2), -(-wo // 2)
    acc = torch.zeros((n * ho2 * wo2, 4 * k), dtype=torch.float32, device=xs8.device)
    for qh in range(fq8):
        for qw in range(fq8):
            acc.addmm_(xs8[:, qh : qh + ho2, qw : qw + wo2, :].float().reshape(-1, gch), wcols[qh, qw].float())
    acc = acc.reshape(n, ho2, wo2, 2, 2, k).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * ho2, 2 * wo2, k)
    return _epilogue_plain(acc[:, :ho, :wo, :], b, relu, xs8.dtype, None)


def conv_g8_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Plain version of the g8 kernel: the wrapper's operands, then
    :func:`conv_g8_packed_plain`."""
    xs8, wcols, ho, wo = _g8_operands(x, w, stride, padding)
    return conv_g8_packed_plain(xs8, wcols, b, ho=ho, wo=wo, relu=relu)


def conv_g8_packed(
    xs8: torch.Tensor, wcols: torch.Tensor, b: torch.Tensor, *, ho: int, wo: int, relu: bool = True,
) -> torch.Tensor:
    """The g8 kernel alone, on ``xs8`` (N, Hs8, Ws8, G) and ``wcols`` (fq8,
    fq8, G, 4K) as :func:`_g8_operands` packs them: (N, ho, wo, K) in xs8's
    dtype. A CPU tensor runs :func:`conv_g8_packed_plain`."""
    dev = _check("conv_g8", xs8, wcols, b)
    k4 = wcols.shape[-1]
    # the conv's pixels are the ceil(ho/2) x ceil(wo/2) phase pixels
    n, fq8 = _packed_conv_dims("conv_g8", xs8, wcols, b, k4 // 4 if k4 % 4 == 0 else 0, -(-ho // 2), -(-wo // 2))
    if dev.type == "cpu":
        return conv_g8_packed_plain(xs8, wcols, b, ho=ho, wo=wo, relu=relu)
    _check_packed_cuda("conv_g8", xs8, n * ho * wo * (k4 // 4))
    y = torch.empty((n, ho, wo, k4 // 4), dtype=xs8.dtype, device=dev)
    _launch(
        "conv_g8", "conv_g8", xs8, xs8.data_ptr(), wcols.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, xs8.shape[1], xs8.shape[2], xs8.shape[3], k4 // 4, fq8, ho, wo, int(relu),
    )
    return y


def conv_g8(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int, relu: bool = True,
) -> torch.Tensor:
    """Phase-packed conv + bias + optional ReLU: the g8 body, for stride >=
    2 (at stride 1 there are no phases to pack: the caller runs vcol, as
    the JAX package does). Arguments and result as :func:`conv2d_bias_relu`
    without ``k_block``/``hpool``, which the JAX package's g8 route ignores
    and refuses.

    Replaces ``_conv_g8_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    pallas_kernels.py). Bound on the H100: operations (conv1 59 GFLOP at
    batch 128 with the weight frames' zeros, against vcol's 27): FFMA in
    fp32, the tensor cores in bf16. Design (``csrc/conv_g8.cu`` on the
    Hopper mainloop of ``csrc/conv_sm90.cuh``): the input packed at g =
    2*stride (g*g*C channels) and the four phase weight frames packed here
    (``ops/packing.py``) side by side as 4K columns; then
    :func:`conv_g8_packed`: one GEMM over the phase pixels, each one's
    window gathered once for the four phases, its store writing each
    column straight into the interleaved (N, Ho, Wo, K) output."""
    _conv_geometry("conv_g8", x, w, b, stride, padding)
    if stride < 2:
        raise ValueError(f"conv_g8: no phases to pack at stride {stride}; run vcol")
    xs8, wcols, ho, wo = _g8_operands(x, w, stride, padding)
    return conv_g8_packed(xs8, wcols, b, ho=ho, wo=wo, relu=relu)


# --------------------------------------------------------------------- pool


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def max_step_plain(best: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The pools' max step on whole tensors (``common.cuh`` ``takes_max``,
    ``jnp.maximum``'s rule): ``v`` takes over where it is greater, a NaN
    (the later NaN's bits are kept) or +0.0 over a best of -0.0."""
    return torch.where((v > best) | torch.isnan(v) | ((v == best) & torch.signbit(best) & ~torch.signbit(v)), v, best)


def maxpool_rect_plain(x: torch.Tensor, *, window, stride) -> torch.Tensor:
    """Plain version of the pool kernel: the max over the window's taps
    (``window``/``stride``: an int, or (rows, cols)) in (fy, fx) order from
    tap (0, 0) by :func:`max_step_plain`, in the input dtype (max is
    exact)."""
    (wh, ww), (sh, sw) = _pair(window), _pair(stride)
    _n, h, wd, _c = x.shape
    ho, wo = pool_out_dim(h, wh, sh), pool_out_dim(wd, ww, sw)

    def tap(fy, fx):
        return x[:, fy : fy + sh * (ho - 1) + 1 : sh, fx : fx + sw * (wo - 1) + 1 : sw, :]

    out = tap(0, 0)
    for fy in range(wh):
        for fx in range(ww):
            out = max_step_plain(out, tap(fy, fx))
    return out.contiguous()


def maxpool2d_plain(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    return maxpool_rect_plain(x, window=window, stride=stride)


def vector_width(c: int, dtype: torch.dtype, *ptrs: int) -> int:
    """The channel-vector width of the instance of ``maxpool.cu``,
    ``lrn.cu``, the phases pool or a pack that takes ``c`` channels of
    ``dtype`` at the addresses ``ptrs``: 16 bytes' worth (4 fp32, 8 bf16)
    where a pixel's channels fill whole vectors and every pointer is
    16-byte aligned, else 1 (the scalar instance)."""
    vec = 16 // dtype.itemsize
    return vec if c % vec == 0 and all(ptr % 16 == 0 for ptr in ptrs) else 1


def _pool(x: torch.Tensor, wh: int, ww: int, sh: int, sw: int, name: str) -> torch.Tensor:
    dev = _check(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not NHWC")
    n, h, wd, c = x.shape
    ho, wo = pool_out_dim(h, wh, sh), pool_out_dim(wd, ww, sw)
    if min(n, ho, wo, c) <= 0:
        raise ValueError(f"{name}: empty output for x {tuple(x.shape)}, window {wh}x{ww}")
    if dev.type == "cpu":
        return maxpool_rect_plain(x, window=(wh, ww), stride=(sh, sw))
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: x past 2^31 elements (the kernel's 32-bit index)")
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=dev)
    vec = vector_width(c, x.dtype, x.data_ptr(), y.data_ptr())
    _launch("maxpool2d", "maxpool2d", x, x.data_ptr(), y.data_ptr(), n, h, wd, c, wh, ww, sh, sw, ho, wo, vec)
    return y


def maxpool2d(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` / ``stride`` max-pool, NHWC, fp32 or bf16.

    Replaces ``_axis_pool_kernel`` behind ``_maxpool_sep2``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py), which the
    TPU launches twice per pool. Bound on the H100: bytes. Design
    (``csrc/maxpool.cu``): one 2-D pass; a thread owns a 16-byte channel
    vector (:func:`vector_width`) of one output column and walks a band of
    output rows, the 3x3/2 window in registers so each new row loads only
    its new input rows, the max an integer max of order keys (-0.0 below
    +0.0; a NaN in the window takes the rule of :func:`max_step_plain`);
    bitwise equal to the two passes."""
    return _pool(x, window, window, stride, stride, "maxpool2d")


def maxpool2d_w(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """The W-axis stage of a ``window``/``stride`` max-pool alone (a 1 x
    window pool): what follows a conv whose hpool epilogue took the H-axis
    max. The TPU's ``maxpool_pallas_w`` (``_axis_pool_kernel`` on the
    transposed tensor); here the same ``csrc/maxpool.cu`` kernel as
    :func:`maxpool2d` (counted as ``maxpool2d``) with a rectangular window,
    so hpool conv + this is bitwise conv + :func:`maxpool2d`."""
    return _pool(x, 1, window, 1, stride, "maxpool2d_w")


def _phase_dims(name: str, x: torch.Tensor, window: int, stride: int) -> tuple:
    """Check a pool's NHWC input; ``(n, h, wd, c, ho, wo, q)``, q = (window-1)//stride."""
    _check(name, x)
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not NHWC")
    n, h, wd, c = x.shape
    ho, wo = pool_out_dim(h, window, stride), pool_out_dim(wd, window, stride)
    if min(n, ho, wo, c) <= 0:
        raise ValueError(f"{name}: empty output for x {tuple(x.shape)}, window {window}")
    return n, h, wd, c, ho, wo, (window - 1) // stride


def _index_fits(name: str, *tensors: torch.Tensor) -> None:
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f"{name}: an operand past 2^31 elements (the kernel's 32-bit index)")


def pool_phases_pack(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """The phase stack of a ``window``/``stride`` pool of NHWC ``x``,
    (s*s, N, hp, wp, C) (:func:`packing.pool_phases`, hp = ho + (window-1)//s),
    bitwise, in one pass (``csrc/maxpool_phases.cu`` ``pool_phases_pack``:
    x read once, the stack written once, 16-byte vectors where
    :func:`vector_width` says so). A CPU tensor runs the plain pack."""
    dev = x.device
    n, h, wd, c, ho, wo, q = _phase_dims("pool_phases_pack", x, window, stride)
    if dev.type == "cpu":
        return packing.pool_phases(x, stride, ho + q, wo + q)
    xph = torch.empty((stride * stride, n, ho + q, wo + q, c), dtype=x.dtype, device=dev)
    _index_fits("pool_phases_pack", x, xph)
    vec = vector_width(c, x.dtype, x.data_ptr(), xph.data_ptr())
    _launch("pool_phases_pack", "pool_phases_pack", x, x.data_ptr(), xph.data_ptr(),
            n, h, wd, c, ho + q, wo + q, stride, vec)
    return xph


def maxpool_phases_packed_plain(xph: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """Plain version of the phases kernel on its stack ``xph`` (s*s, N, hp,
    wp, C): the max over the taps (fy, fx) in order from tap (0, 0), each a
    unit-stride slice of phase (fy%s)*s + fx%s."""
    s, q = stride, (window - 1) // stride
    ho, wo = xph.shape[2] - q, xph.shape[3] - q

    def tap(fy, fx):
        return xph[(fy % s) * s + fx % s, :, fy // s : fy // s + ho, fx // s : fx // s + wo, :]

    out = tap(0, 0)
    for fy in range(window):
        for fx in range(window):
            out = max_step_plain(out, tap(fy, fx))
    return out.contiguous()


def maxpool_phases_plain(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """Plain version of :func:`maxpool_phases`: the plain stack, then
    :func:`maxpool_phases_packed_plain`."""
    _n, h, wd, _c = x.shape
    q = (window - 1) // stride
    hp, wp = pool_out_dim(h, window, stride) + q, pool_out_dim(wd, window, stride) + q
    return maxpool_phases_packed_plain(packing.pool_phases(x, stride, hp, wp), window=window, stride=stride)


def maxpool_phases_packed(xph: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """The phases pool kernel on its stack ``xph`` (:func:`pool_phases_pack`,
    contiguous (s*s, N, hp, wp, C)): (N, hp - q, wp - q, C), q =
    (window-1)//stride, in ``xph``'s dtype. A CPU tensor runs
    :func:`maxpool_phases_packed_plain`."""
    dev = _check("maxpool_phases", xph)
    if xph.dim() != 5 or xph.shape[0] != stride * stride:
        raise ValueError(f"maxpool_phases: stack {tuple(xph.shape)} is not (s*s, N, hp, wp, C), s = {stride}")
    _ss, n, hp, wp, c = xph.shape
    q = (window - 1) // stride
    ho, wo = hp - q, wp - q
    if min(n, ho, wo, c, window, stride) <= 0:
        raise ValueError(f"maxpool_phases: empty output for stack {tuple(xph.shape)}, window {window}")
    if dev.type == "cpu":
        return maxpool_phases_packed_plain(xph, window=window, stride=stride)
    _index_fits("maxpool_phases", xph)
    y = torch.empty((n, ho, wo, c), dtype=xph.dtype, device=dev)
    vec = vector_width(c, xph.dtype, xph.data_ptr(), y.data_ptr())
    _launch("maxpool_phases", "maxpool_phases", xph, xph.data_ptr(), y.data_ptr(),
            n, hp, wp, c, window, stride, ho, wo, vec)
    return y


def maxpool_phases(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` / ``stride`` max-pool over a stride-phase
    stack: the phases pool body. Bitwise :func:`maxpool2d`.

    Replaces ``_pool_kernel`` behind ``_maxpool_phases``
    (cuda_mpi_gpu_cluster_programming_tpu/ops/pallas_kernels.py) and its
    ``_pool_phases``. Bound on the H100: bytes. Design
    (``csrc/maxpool_phases.cu``): :func:`pool_phases_pack` writes the (s*s,
    N, hp, wp, C) stack in one pass, then :func:`maxpool_phases_packed`
    pools it as :func:`maxpool2d` pools x: a thread owns a 16-byte channel
    vector of one output column and walks a band of output rows, the 3x3/2
    window's order keys in registers. A CPU tensor runs the plain pack and
    pool (:func:`maxpool_phases_plain`)."""
    return maxpool_phases_packed(pool_phases_pack(x, window=window, stride=stride), window=window, stride=stride)


# The s2d pool pads C to a multiple of this, so that every phase's channel
# block starts on a 16-byte boundary (the TPU's 128 lanes).
S2D_LANES = 128


def s2d_pool_operand(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """The operand of the s2d pool kernel for NHWC ``x``, plain: C
    zero-padded to a multiple of :data:`S2D_LANES`, then the space-to-depth
    repack (N, ho + q, wo + q, s*s*cp), q = (window-1)//s, as ``pool_s2d128``
    builds it. The zero rows and columns of the repack are never read."""
    _n, h, wd, _c = x.shape
    q = (window - 1) // stride
    ho, wo = pool_out_dim(h, window, stride), pool_out_dim(wd, window, stride)
    return packing.space_to_depth(packing.pad_channels(x, S2D_LANES), stride, ho + q, wo + q)


def s2d_pool_pack(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """:func:`s2d_pool_operand` of ``x``, bitwise and contiguous, in one pass
    (``csrc/maxpool_s2d.cu`` ``s2d_pool_pack``: x read once, the operand
    written once, 16-byte vectors where :func:`vector_width` says so). A CPU
    tensor runs the plain pack."""
    dev = x.device
    n, h, wd, c, ho, wo, q = _phase_dims("s2d_pool_pack", x, window, stride)
    if dev.type == "cpu":
        return s2d_pool_operand(x, window=window, stride=stride).contiguous()
    cp = -(-c // S2D_LANES) * S2D_LANES
    xs = torch.empty((n, ho + q, wo + q, stride * stride * cp), dtype=x.dtype, device=dev)
    _index_fits("s2d_pool_pack", x, xs)
    vec = vector_width(c, x.dtype, x.data_ptr(), xs.data_ptr())
    _launch("s2d_pool_pack", "s2d_pool_pack", x, x.data_ptr(), xs.data_ptr(),
            n, h, wd, c, ho + q, wo + q, stride, cp, vec)
    return xs


def _s2d_dims(xs: torch.Tensor, c: int, window: int, stride: int) -> tuple:
    """``(n, hs, ws, cp, ho, wo)`` of an s2d operand holding ``c`` channels."""
    n, hs, ws, depth = xs.shape
    q = (window - 1) // stride
    return n, hs, ws, depth // (stride * stride), hs - q, ws - q


def maxpool_s2d_packed_plain(xs: torch.Tensor, c: int, *, window: int, stride: int) -> torch.Tensor:
    """Plain version of the s2d kernel on its operand ``xs``: over the taps
    (fy, fx) in order from tap (0, 0), each a unit-stride slice of channel
    block (fy%s)*s + fx%s, the kernel's max step (:func:`max_step_plain`),
    cropped to ``c`` channels."""
    s = stride
    _n, _hs, _ws, cp, ho, wo = _s2d_dims(xs, c, window, s)

    def tap(fy, fx):
        ph = (fy % s) * s + fx % s
        return xs[:, fy // s : fy // s + ho, fx // s : fx // s + wo, ph * cp : ph * cp + c]

    out = tap(0, 0)
    for fy in range(window):
        for fx in range(window):
            out = max_step_plain(out, tap(fy, fx))
    return out.contiguous()


def maxpool_s2d_plain(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """Plain version of :func:`maxpool_s2d`: the same operand, then
    :func:`maxpool_s2d_packed_plain`."""
    return maxpool_s2d_packed_plain(
        s2d_pool_operand(x, window=window, stride=stride), x.shape[3], window=window, stride=stride)


def maxpool_s2d_packed(xs: torch.Tensor, c: int, *, window: int, stride: int) -> torch.Tensor:
    """The s2d pool kernel on its operand ``xs`` (:func:`s2d_pool_operand`,
    contiguous): (N, ho, wo, c) in ``xs``'s dtype. A CPU tensor runs
    :func:`maxpool_s2d_packed_plain`."""
    dev = _check("maxpool_s2d", xs)
    if xs.dim() != 4 or xs.shape[3] % (stride * stride * S2D_LANES):
        raise ValueError(f"maxpool_s2d: operand {tuple(xs.shape)} is not (N, hs, ws, s*s*cp), cp a multiple of "
                         f"{S2D_LANES}")
    n, hs, ws, cp, ho, wo = _s2d_dims(xs, c, window, stride)
    if min(n, ho, wo, c) <= 0 or c > cp:
        raise ValueError(f"maxpool_s2d: empty output or {c} channels for operand {tuple(xs.shape)}")
    if dev.type == "cpu":
        return maxpool_s2d_packed_plain(xs, c, window=window, stride=stride)
    _index_fits("maxpool_s2d", xs)
    if xs.data_ptr() % 16:
        xs = xs.clone()  # the kernel's vector loads need a 16-byte aligned operand
    y = torch.empty((n, ho, wo, c), dtype=xs.dtype, device=dev)
    _launch("maxpool_s2d", "maxpool_s2d", xs, xs.data_ptr(), y.data_ptr(), n, hs, ws, cp, c, window, stride, ho, wo)
    return y


def maxpool_s2d(x: torch.Tensor, *, window: int, stride: int) -> torch.Tensor:
    """VALID ``window`` x ``window`` / ``stride`` max-pool over a
    space-to-depth repack, NHWC in, (N, ho, wo, C) out, fp32 or bf16:
    ``pool_s2d128``, the A/B's ``s2d128``. Bitwise :func:`maxpool2d`.

    Replaces ``_s2d_pool_kernel`` (scripts/pool_ab.py) and its pad and
    repack. Bound on the H100: bytes. Design (``csrc/maxpool_s2d.cu``):
    :func:`s2d_pool_pack` writes the C-padded repack in one pass, then
    :func:`maxpool_s2d_packed` pools it: a thread owns a 16-byte channel
    vector of one output column and walks a band of output rows, the 3x3/2
    window's order keys in registers, each tap one vector load from its
    channel block (C padded to 128 keeps the blocks aligned), the cropped C
    channels stored directly. A CPU tensor runs the plain pack and pool
    (:func:`maxpool_s2d_plain`)."""
    return maxpool_s2d_packed(s2d_pool_pack(x, window=window, stride=stride), x.shape[3], window=window,
                              stride=stride)


# ---------------------------------------------------------------------- LRN


def _lrn_a(alpha: float, size: int, alpha_over_size: bool) -> float:
    return alpha / size if alpha_over_size else alpha


def lrn_plain(
    x: torch.Tensor, *, size: int, alpha: float, beta: float, k: float, alpha_over_size: bool = False
) -> torch.Tensor:
    """Plain version of the LRN kernel: fp32 throughout, the window sum as
    shifted adds in the kernel's order (channel c-size//2 first; the zero
    padding adds exact zeros), one cast to ``x.dtype``."""
    half = size // 2
    c = x.shape[-1]
    xf = x.float()
    sq = F.pad(xf * xf, (half, half))
    ssum = torch.zeros_like(xf)
    for d in range(2 * half + 1):
        ssum = ssum + sq[..., d : d + c]
    scale = k + _lrn_a(alpha, size, alpha_over_size) * ssum
    return (xf / torch.pow(scale, beta)).to(x.dtype)


def lrn(
    x: torch.Tensor, *, size: int, alpha: float, beta: float, k: float, alpha_over_size: bool = False
) -> torch.Tensor:
    """Cross-channel LRN over the last (channel) axis, fp32 math, output in
    ``x.dtype``: ``x / (k + a * sum of x^2 over the edge-cut window)^beta``
    with ``a = alpha`` or ``alpha/size``.

    Replaces ``_lrn_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    pallas_kernels.py). Bound on the H100: bytes. Design (``csrc/lrn.cu``):
    a block takes a tile of pixels x up to 1024 channels in 16-byte vectors
    (:func:`vector_width`), each square computed once into shared memory;
    a thread then sums its vector's windows from there (the TPU's banded
    matmul was a lane-slicing workaround), powf and a divide."""
    dev = _check("lrn", x)
    if x.dim() < 1 or x.numel() == 0 or size < 1:
        raise ValueError(f"lrn: x {tuple(x.shape)}, size {size}")
    if dev.type == "cpu":
        return lrn_plain(x, size=size, alpha=alpha, beta=beta, k=k, alpha_over_size=alpha_over_size)
    y = torch.empty_like(x)
    c = x.shape[-1]
    _launch(
        "lrn", "lrn", x, x.data_ptr(), y.data_ptr(), x.numel(), c, size,
        _lrn_a(alpha, size, alpha_over_size), beta, k, vector_width(c, x.dtype, x.data_ptr(), y.data_ptr()),
    )
    return y


# --------------------------------------------------------------- fused block


def conv_block_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int,
    pool_window: int, pool_stride: int, lrn=None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the block kernel.

    fp32 and bf16 (``scale`` None): the staged plain chain
    ``conv2d_bias_relu_plain`` -> ``maxpool2d_plain`` (-> ``lrn_plain``),
    so it is bitwise that chain by construction. int8w (``scale`` given):
    the fp32 accumulator of the same per-tap loop, times ``scale``, plus
    the fp32 bias, ReLU, a cast to bf16, the pool, then (block 2) LRN in
    fp32 with an fp32 result."""
    if scale is None:
        out = conv2d_bias_relu_plain(x, w, b, stride=stride, padding=padding, relu=True)
    else:
        acc = _conv_acc_plain(x, w, stride=stride, padding=padding)
        out = relu_plain(acc * scale + b).to(torch.bfloat16)
    out = maxpool2d_plain(out, window=pool_window, stride=pool_stride)
    if lrn is not None:
        out = lrn_plain(
            out if scale is None else out.float(), size=lrn.size, alpha=lrn.alpha, beta=lrn.beta, k=lrn.k,
            alpha_over_size=lrn.alpha_over_size,
        )
    return out


def conv_block(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, stride: int, padding: int,
    pool_window: int, pool_stride: int, lrn=None, scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One fused block: conv (+ int8w rescale) + bias + ReLU + VALID max-pool
    (+ cross-channel LRN when ``lrn``, an object with ``size``, ``alpha``,
    ``beta``, ``k`` and ``alpha_over_size``, is given).

    ``x`` (N, H, W, C) and ``w`` (F, F, C, K) HWIO, ``b`` (K,): all fp32 or
    all bf16 -> output in ``x.dtype``. int8w: ``x`` bf16, ``w`` int8, ``b``
    and ``scale`` (K,) fp32 -> bf16 without LRN, fp32 with it.

    Replaces ``_block_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    megakernel.py). Bound on the H100: operations (block 1 27.0 GFLOP,
    block 2 114.7 GFLOP at batch 128). Design (``csrc/conv_block.cu``): a
    block walks a band of pooled rows of one image, computes the conv rows
    each pooled row needs into a ring of 3 rows in shared memory (all
    channels when LRN needs its neighbours) on conv2d's mainloop
    (``csrc/conv_sm90.cuh``), pools (and normalises) from the ring and
    writes once. fp32 and bf16 results are bitwise the staged kernel
    chain's: the same FMA chain or tensor-core steps, cast points, max and
    LRN arithmetic."""
    quant = scale is not None
    if quant:
        dev = _check("conv_block", b, scale)
        _check("conv_block", x)
        if x.dtype != torch.bfloat16 or b.dtype != torch.float32 or w.dtype != torch.int8:
            raise TypeError(f"conv_block int8w: needs bf16 x, int8 w, fp32 b and scale, got "
                            f"{[t.dtype for t in (x, w, b, scale)]}")
        if x.device != dev or w.device != dev or not w.is_contiguous():
            raise ValueError("conv_block int8w: needs contiguous tensors on one device")
    else:
        dev = _check("conv_block", x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv_block: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit NHWC/HWIO")
    k = w.shape[3]
    if b.shape != (k,) or (quant and scale.shape != (k,)):
        raise ValueError(f"conv_block: bias/scale shapes for {k} channels")
    n, h, wd, c = x.shape
    f = w.shape[0]
    ho, wo = conv_out_dim(h, f, padding, stride), conv_out_dim(wd, f, padding, stride)
    hp, wp = pool_out_dim(ho, pool_window, pool_stride), pool_out_dim(wo, pool_window, pool_stride)
    if min(n, hp, wp, k) <= 0:
        raise ValueError(f"conv_block: empty output for x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), n * ho * wo * k, f * f * c * k) >= 2**31 or n > 65535:
        raise ValueError("conv_block: tensors past 2^31 elements or a batch past 65535")
    kw = dict(stride=stride, padding=padding, pool_window=pool_window, pool_stride=pool_stride)
    if dev.type == "cpu":
        return conv_block_plain(x, w, b, lrn=lrn, scale=scale, **kw)
    _check_sm90_dims("conv_block", h, wd, padding)
    out_dtype = (torch.float32 if lrn is not None else torch.bfloat16) if quant else x.dtype
    y = torch.empty((n, hp, wp, k), dtype=out_dtype, device=dev)
    lrn_args = (0, 0, 0.0, 0.0, 0.0)  # has_lrn, size, a, beta, k
    if lrn is not None:
        lrn_args = (1, lrn.size, _lrn_a(lrn.alpha, lrn.size, lrn.alpha_over_size), lrn.beta, lrn.k)
    _launch(
        "conv_block", "conv_block", x, x.data_ptr(), w.data_ptr(), b.data_ptr(),
        scale.data_ptr() if quant else None, y.data_ptr(),
        n, h, wd, c, k, f, stride, padding, ho, wo, pool_window, pool_stride, hp, wp, CONV_BLOCK_BAND, *lrn_args,
        suffix="int8w" if quant else "",
    )
    return y


# --------------------------------------------------------------------- relu


def relu_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the ReLU kernel, ``jnp.maximum(x, 0)``: NaN kept
    with its bits, -0.0 and everything else not above 0 to +0.0."""
    return torch.where((x > 0) | torch.isnan(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def relu(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ReLU of any shape, fp32 or bf16, output in ``x.dtype``.

    Replaces the inline kernel of ``relu_pallas`` (cuda_mpi_gpu_cluster_
    programming_tpu/ops/pallas_kernels.py). No path calls it: the conv
    kernels fuse their ReLU, and this is the unfused launch. Bound on the
    H100: bytes. Design (``csrc/relu.cu``): one launch, a grid-stride loop
    over 16-byte chunks, then the tail element by element; on the H100 it
    runs at 1.04-1.07x ``torch.relu``'s device time (``PERF.md``), so what
    its CUDA-event time adds is the host's launch through ctypes, the path
    every single-launch wrapper takes (``_launch``)."""
    dev = _check("relu", x)
    if dev.type == "cpu":
        return relu_plain(x)
    y = torch.empty_like(x)
    if x.numel():
        _launch("relu", "relu", x, x.data_ptr(), y.data_ptr(), x.numel())
    return y


# ---------------------------------------------------- flash attention forward


# The head dims the flash kernels are instantiated for. A CUDA tensor with
# another D up to 256 is zero-padded to the next of them; above 256 to the
# next multiple of FLASH_CHUNK, which one more instance of each kernel takes
# at run time, a block owning FLASH_WINDOW output columns (:func:`flash_width`).
# The plain versions, and so the CPU, take any D.
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)
FLASH_CHUNK = 64
FLASH_WINDOW = 256


def flash_width(d: int) -> tuple:
    """``(dp, windows)`` for head dim ``d`` on the card: the width the
    kernels run at, and how many windows of ``FLASH_WINDOW`` output columns
    each (b, h, 64-row tile) is split into (1 up to 256). Every window sums
    the scores over all ``dp`` columns and writes its own columns of the
    outputs."""
    if d <= FLASH_HEAD_DIMS[-1]:
        return next(w for w in FLASH_HEAD_DIMS if w >= d), 1
    dp = -(-d // FLASH_CHUNK) * FLASH_CHUNK
    return dp, -(-dp // FLASH_WINDOW)


def flash_blocks(l: int, block_q: int, block_k: int) -> tuple:
    """The clamped ``(bq, bk)`` for sequence length ``l``; raises, in the
    JAX package's words, when ``l`` is not a multiple of both."""
    bq, bk = min(block_q, l), min(block_k, l)
    if l % bq or l % bk:
        raise ValueError(f"sequence length {l} not divisible by blocks ({bq}, {bk})")
    return bq, bk


def _flash_check(*tensors: torch.Tensor, name: str = "flash_fwd") -> torch.device:
    """Check the (B, L, H, D) operands of a flash kernel (q, k, v, and the
    output gradient for the backward): one device, one shape with no empty
    axis, each fp32 or bf16. What the JAX kernel takes passes: the dtypes
    may mix (it widens every operand to fp32), any strides, any B, H and D;
    the CUDA branch prepares what the kernels cannot read
    (:func:`_flash_operands`)."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name}: needs fp32 or bf16 operands, got {[u.dtype for u in tensors]}")
        if t.dim() != 4 or t.shape != first.shape:
            raise ValueError(f"{name}: needs q, k, v of one (B, L, H, D) shape, got "
                             f"{[tuple(u.shape) for u in tensors]}")
    if first.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    if min(first.shape) <= 0:
        raise ValueError(f"{name}: shape {tuple(first.shape)} has an empty axis")
    return first.device


def _flash_operands(*tensors: torch.Tensor) -> tuple:
    """The CUDA operands of a flash kernel as it reads them: one dtype, the
    head axis contiguous, the kernels' width. Mixed fp32/bf16 operands
    become fp32 copies, which is the JAX kernel's arithmetic (it widens
    every operand to fp32); the caller casts each output to the dtype JAX
    gives it. An operand whose last stride is not 1 becomes a contiguous
    copy; the other axes are read through their strides. Then
    :func:`_flash_pad`."""
    if len({t.dtype for t in tensors}) > 1:
        tensors = tuple(t.float() for t in tensors)
    return _flash_pad(*(t if t.stride(-1) == 1 else t.contiguous() for t in tensors))


def _flash_pad(*tensors: torch.Tensor) -> tuple:
    """The CUDA operands of a flash kernel at head dim D: unchanged when D is
    the width :func:`flash_width` runs it at, else copies zero-padded on the
    last axis to that width. Zero columns leave every score q.k, lse and
    delta = sum dO.o unchanged, and the padded columns of out, dq, dk and
    dv come out exactly 0; the caller passes the scale of the true D and
    slices them away. A padded operand is a copy, so the kernels lose their
    strided read of a packed qkv at such a D."""
    d = tensors[0].shape[-1]
    dp, _windows = flash_width(d)
    if dp == d:
        return tensors
    return tuple(F.pad(t, (0, dp - d)) for t in tensors)


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, block_q: int = 128, block_k: int = 128,
    scale: float | None = None,
) -> tuple:
    """Plain version of the flash forward kernel: the same recurrence in
    PyTorch, every q row at once, over k-blocks of the clamped ``block_k``.

    Exact, not approximate: the running max starts at ``NEG_INF`` and block
    0 holds key 0, which every row sees, so a masked score adds
    exp(NEG_INF - m) = 0, as in the JAX kernel. Returns ``(out, lse)``:
    out (B, L, H, D) in q's dtype, lse (B, H, L) fp32. ``scale`` (default
    1/sqrt(D)) is the padded kernels' true-D scale, for the tests."""
    b, l, h, d = q.shape
    _bq, bk = flash_blocks(l, block_q, block_k)
    scale = 1.0 / d**0.5 if scale is None else scale
    qf = (q.float() * scale).permute(0, 2, 1, 3)  # (B, H, L, D)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, l), NEG_INF, device=q.device)
    den = torch.zeros((b, h, l), device=q.device)
    acc = torch.zeros((b, h, l, d), device=q.device)
    rows = torch.arange(l, device=q.device)[:, None]
    for k0 in range(0, l, bk):
        s = qf @ kf[:, :, k0 : k0 + bk].transpose(-1, -2)  # (B, H, L, bk)
        if causal:
            s = torch.where(rows >= torch.arange(k0, k0 + bk, device=q.device)[None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * corr[..., None] + p @ vf[:, :, k0 : k0 + bk]
        den = den * corr + p.sum(dim=-1)
        m = m_new
    den = den.clamp_min(1e-30)
    out = (acc / den[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return out, m + torch.log(den)


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, block_q: int = 128, block_k: int = 128,
) -> tuple:
    """Flash-attention forward: ``(out, lse)`` for q, k, v of shape
    (B, L, H, D), each fp32 or bf16; out in q's dtype, lse (B, H, L) fp32 =
    m + log(max(den, 1e-30)). Any D: on CUDA run at the width
    :func:`flash_width` gives (zero-padded, :func:`_flash_pad`). Mixed
    dtypes compute in fp32, as the JAX kernel does; any strides.

    ``block_q``/``block_k`` are clamped to L and L must be a multiple of
    both (:func:`flash_blocks`); the kernel tiles by its own 64 x 64. The
    (B, L, H) axes are read through their strides (a slice of a packed qkv
    tensor needs no copy); a last axis with another stride than 1 is
    copied first (:func:`_flash_operands`).

    Replaces ``_fwd_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    flash_attention.py). Bound on the H100: operations (4 B H L^2 D FLOPs,
    half when causal). Design (``csrc/flash_fwd.cu`` over
    ``csrc/flash_bwd_sm90.cuh``): one block per (b, h, 64-row q tile), the
    heaviest causal tiles first, K/V tiles streamed through shared memory
    by cp.async, the row statistics in registers; no atomics, so a second
    launch gives the same bits. At every D, bf16 runs on the tensor cores
    (mma.sync; p split into two bf16 terms for the p v product) and fp32 on
    register-tiled FFMA in the operations and order of the earlier FFMA
    kernels (their bits). At D = 256 and above a block is 8 warps and owns
    a window of 256 output columns (128 on a grid smaller than the card),
    the operands moving as 64-column chunks through a cp.async ring; every
    window sums the scores over all of D."""
    dev = _flash_check(q, k, v)
    b, l, h, d = q.shape
    flash_blocks(l, block_q, block_k)
    if dev.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, block_q=block_q, block_k=block_k)
    out_dtype = q.dtype
    q, k, v = _flash_operands(q, k, v)
    dp = q.shape[-1]
    out = torch.empty((b, l, h, dp), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=dev)
    _launch(
        "flash_fwd", "flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, l, h, dp, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal), 1.0 / d**0.5,
    )
    return _flash_out(out, d, out_dtype), lse


def _flash_out(t: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """A kernel's output at the caller's D and dtype: the padded columns
    sliced away, an fp32 result of mixed operands cast to ``dtype``."""
    if t.shape[-1] != d:
        t = t[..., :d].contiguous()
    return t.to(dtype)


# --------------------------------------------------- flash attention backward


def _flash_bwd_check(name: str, q, k, v, g, lse, delta) -> torch.device:
    dev = _flash_check(q, k, v, g, name=name)
    b, l, h, _d = q.shape
    for what, t in (("lse", lse), ("delta", delta)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (b, h, l) or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous fp32 (B, H, L) = {(b, h, l)} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return dev


def _bwd_operands(q, k, v, g, scale):
    """fp32 (B, H, L, D) views of q (times the scale), q, k, v and g; the
    scale defaults to 1/sqrt(D)."""
    scale = 1.0 / q.shape[-1] ** 0.5 if scale is None else scale
    qf, kf, vf, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, g))
    return scale, qf * scale, qf, kf, vf, gf


def flash_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
    causal: bool, block_q: int = 128, block_k: int = 128, scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the dQ kernel: ``_dq_kernel``'s blockwise recompute,
    every q row at once, over k-blocks of the clamped ``block_k``:
    p = exp(s - lse) with masked scores at ``NEG_INF`` (p exactly 0),
    dS = p (dO v^T - delta), dq += scale dS k. Returns dq (B, L, H, D) in
    q's dtype. ``scale`` as in :func:`flash_fwd_plain`."""
    b, l, h, d = q.shape
    _bq, bk = flash_blocks(l, block_q, block_k)
    scale, qs, _qf, kf, vf, gf = _bwd_operands(q, k, v, g, scale)
    dq = torch.zeros((b, h, l, d), device=q.device)
    rows = torch.arange(l, device=q.device)[:, None]
    for k0 in range(0, l, bk):
        kb, vb = kf[:, :, k0 : k0 + bk], vf[:, :, k0 : k0 + bk]
        s = qs @ kb.transpose(-1, -2)  # (B, H, L, bk)
        if causal:
            s = torch.where(rows >= torch.arange(k0, k0 + bk, device=q.device)[None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])
        ds = p * (gf @ vb.transpose(-1, -2) - delta[..., None])
        dq = dq + scale * (ds @ kb)
    return dq.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_dkv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
    causal: bool, block_q: int = 128, block_k: int = 128, scale: float | None = None,
) -> tuple:
    """Plain version of the dK/dV kernel: ``_dkv_kernel``'s blockwise
    recompute, every key at once, over q-blocks of the clamped ``block_q``:
    dv += p^T dO, dk += scale dS^T q (q unscaled). Returns ``(dk, dv)``
    (B, L, H, D) in k's and v's dtype. ``scale`` as in :func:`flash_fwd_plain`."""
    b, l, h, d = q.shape
    bq, _bk = flash_blocks(l, block_q, block_k)
    scale, qs, qf, kf, vf, gf = _bwd_operands(q, k, v, g, scale)
    dk = torch.zeros((b, h, l, d), device=q.device)
    dv = torch.zeros((b, h, l, d), device=q.device)
    keys = torch.arange(l, device=q.device)[None, :]
    for q0 in range(0, l, bq):
        gb = gf[:, :, q0 : q0 + bq]
        s = qs[:, :, q0 : q0 + bq] @ kf.transpose(-1, -2)  # (B, H, bq, L)
        if causal:
            s = torch.where(torch.arange(q0, q0 + bq, device=q.device)[:, None] >= keys, s, NEG_INF)
        p = torch.exp(s - lse[:, :, q0 : q0 + bq, None])
        dv = dv + p.transpose(-1, -2) @ gb
        ds = p * (gb @ vf.transpose(-1, -2) - delta[:, :, q0 : q0 + bq, None])
        dk = dk + scale * (ds.transpose(-1, -2) @ qf[:, :, q0 : q0 + bq])
    return (dk.to(k.dtype).permute(0, 2, 1, 3).contiguous(), dv.to(v.dtype).permute(0, 2, 1, 3).contiguous())


def _bwd_args(q, k, v, g) -> tuple:
    b, l, h, d = q.shape
    return (b, l, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3])


def flash_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
    causal: bool, block_q: int = 128, block_k: int = 128,
) -> torch.Tensor:
    """Flash-attention backward, dQ: dq (B, L, H, D) in q's dtype from q, k,
    v and the output gradient g (all (B, L, H, D), each fp32 or bf16, any
    strides: as :func:`flash_fwd` takes them) and the fp32 (B, H, L)
    ``lse`` (the forward's) and ``delta`` (sum_d g o, less the lse
    gradient). Blocks and head dims as :func:`flash_fwd`.

    Replaces ``_dq_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    flash_attention.py). Bound on the H100: operations (3 products, 6 B H
    L^2 D FLOPs, half when causal). Design (``csrc/flash_dq.cu`` over
    ``csrc/flash_bwd_sm90.cuh``): one block per (b, h, 64-row q tile),
    heaviest causal tiles first, K/V tiles streamed through shared memory
    by cp.async; no atomics, so a second launch gives the same bits. bf16
    runs on the tensor cores (mma.sync; dS split into two bf16 terms for
    the dS k product) and fp32 on register-tiled FFMA in the operations
    and order of the earlier FFMA kernel (its bits). At D = 256 and above a
    block is 8 warps and owns a window of 256 dq columns (128 where 256
    would leave SMs idle); the operands move as 64-column chunks through a
    cp.async ring, and the scores are summed over all of D chunk after
    chunk. Operands off 16-byte alignment
    (a strided view) are copied element by element inside the kernel into
    the same tiles."""
    dev = _flash_bwd_check("flash_dq", q, k, v, g, lse, delta)
    flash_blocks(q.shape[1], block_q, block_k)
    if dev.type == "cpu":
        return flash_dq_plain(q, k, v, g, lse, delta, causal=causal, block_q=block_q, block_k=block_k)
    d, dq_dtype = q.shape[-1], q.dtype
    q, k, v, g = _flash_operands(q, k, v, g)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _launch(
        "flash_dq", "flash_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_bwd_args(q, k, v, g), int(causal), 1.0 / d**0.5,
    )
    return _flash_out(dq, d, dq_dtype)


def flash_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
    causal: bool, block_q: int = 128, block_k: int = 128,
) -> tuple:
    """Flash-attention backward, dK and dV: ``(dk, dv)`` (B, L, H, D) in k's
    and v's dtype, on the operands of :func:`flash_dq`.

    Replaces ``_dkv_kernel`` (cuda_mpi_gpu_cluster_programming_tpu/ops/
    flash_attention.py). Bound on the H100: operations (4 products, 8 B H
    L^2 D FLOPs, half when causal). Design (``csrc/flash_dkv.cu`` over
    ``csrc/flash_bwd_sm90.cuh``): one block per (b, h, 64-key tile), q/dO
    tiles streamed through shared memory by cp.async from the diagonal on
    (causal); no atomics. bf16 runs on the tensor cores (mma.sync; p and dS
    split into two bf16 terms for the p^T dO and dS^T q products) and fp32
    on register-tiled FFMA with the earlier FFMA kernel's bits. At D = 256
    and above a block is 8 warps and owns a window of 256 dk and dv
    columns (128 where 256 would leave SMs idle), the operands in 64-column
    chunks through a cp.async ring."""
    dev = _flash_bwd_check("flash_dkv", q, k, v, g, lse, delta)
    flash_blocks(q.shape[1], block_q, block_k)
    if dev.type == "cpu":
        return flash_dkv_plain(q, k, v, g, lse, delta, causal=causal, block_q=block_q, block_k=block_k)
    d, dk_dtype, dv_dtype = q.shape[-1], k.dtype, v.dtype
    q, k, v, g = _flash_operands(q, k, v, g)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    _launch(
        "flash_dkv", "flash_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_bwd_args(q, k, v, g), int(causal), 1.0 / d**0.5,
    )
    return _flash_out(dk, d, dk_dtype), _flash_out(dv, d, dv_dtype)
