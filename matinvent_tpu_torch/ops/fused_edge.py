"""Fused fc edge branch of one CSPLayer (``matinvent_tpu/ops/fused_edge.py``).

``fused_edge_chain`` computes, for a batch of crystals,

    fd    = (x_j - x_i) mod 1                         from [B, A, 3] coords
    emb   = concat(sin(2 pi m fd), cos(2 pi m fd))    space-major, m < nf
    e     = silu(emb @ w_d + term_i + term_j)         (term_l and the bias
                                                       folded into term_i)
    s     = silu(e @ w_1 + b_1)
    agg_i = u_i * sum_j s_ij * u_j                    u_i = mask_i / denom_i,
                                                      u_j = mask_j

On a CUDA tensor it launches the hand-written kernel ``csrc/fused_edge.cu``,
which replaces the Pallas TPU kernel ``matinvent_tpu/ops/fused_edge.py:73
_kernel``. The work is bound by arithmetic (two products of
``2 * A^2 * (64 H + H^2)`` flops per crystal against ``O(A H)`` bytes of node
terms), so the kernel runs both products on the tensor cores (bf16 ``mma``,
or 3xTF32 for float32), keeps the ``[A^2, H]`` intermediates in shared
memory and registers, and in bf16 keeps the weights resident in shared
memory of persistent blocks; see the source for its layout. Those tiled
instances take widths 32/64/128/256, up to 64 atoms and 64 lanes; any other
shape runs the kernel's wide route in the same source, which pads the width
to 128-column passes and runs the j-sum of a crystal above 64 atoms over
several 64-row chunks, as the Pallas kernel pads its blocks. The one limit
is the wide route's shared memory (``kernel_takes``: widths up to 640 at 10
frequencies). On a CPU tensor the wrapper runs
``fused_edge_chain_plain``, the same math in plain PyTorch; a CUDA tensor
never takes the plain version.

The same kernel body, with parts switched off at compile time, serves the
fused-edge harnesses (``matinvent_tpu_torch/experiments``) through
``launch_edge_kernel``; ``edge_chain_plain`` and ``phase_embedding`` are the
plain body they all share.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the tiled instances of csrc/fused_edge.cu: these widths, the edge rows of
# a crystal row in one 64-row tile, at most 64 embedding lanes
_HIDDEN = (32, 64, 128, 256)
_MAX_ATOMS = 64
_MAX_LANES = 64
# shared memory of one block that an H100 (sm_90) grants on opt-in, less
# the wide kernel's static tables (fd, two row indices and u_j of 64 rows)
_SMEM_OPTIN = 227 * 1024
_WIDE_STATIC = 64 * (3 + 3) * 4
# modes of csrc/fused_edge.cu's fused_edge_launch
MODES = ("full", "nosin", "nobcast", "noagg", "gemmonly", "demb")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.cache
def phase_consts(num_freqs: int, lanes: int) -> np.ndarray:
    """Per-axis phase-frequency rows ``F[s, l]``, s in {x, y, z}, l < lanes.

    Lane ``l < 3 nf`` holds ``(s, m) = divmod(l, nf)`` of the sin half, lanes
    ``[3 nf, 6 nf)`` repeat the layout for the cos half (the space-major
    ``concat(sin, cos)`` of ``sinusoids_embedding``), lanes ``>= 6 nf`` are
    0. The constants are ``2 pi m`` rounded once from double, as the JAX
    package's Pallas kernels take them (``ops/fused_edge.py:57``).
    """
    fx = np.zeros((3, lanes), np.float32)
    for half in (0, 3 * num_freqs):
        for s in range(3):
            for m in range(num_freqs):
                fx[s, half + s * num_freqs + m] = 2.0 * math.pi * m
    return fx


@functools.cache
def _phase_table(num_freqs: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(phase_consts(num_freqs, 6 * num_freqs)).to(device)


def phase_embedding(
    frac_coords: torch.Tensor, fmat: torch.Tensor, n_sin: int, *, sincos: bool = True
) -> torch.Tensor:
    """``[B, A, A, lanes]`` f32: the phases ``ph = fd . fmat[:, l]`` of
    ``fd = (x_j - x_i) mod 1``, and ``sin(ph)`` on lanes ``< n_sin``,
    ``cos(ph)`` on the others (or the raw phases when ``sincos`` is off)."""
    fr = frac_coords.to(torch.float32)
    fd = fr[:, None, :, :] - fr[:, :, None, :]
    fd = fd - torch.floor(fd)
    fmat = fmat.to(torch.float32)
    ph = fd[..., 0:1] * fmat[0] + fd[..., 1:2] * fmat[1] + fd[..., 2:3] * fmat[2]
    if not sincos:
        return ph
    lane = torch.arange(fmat.shape[1], device=ph.device)
    return torch.where(lane < n_sin, torch.sin(ph), torch.cos(ph))


def edge_chain_plain(
    term_i: torch.Tensor,  # [B, A, H] compute dtype
    term_j: torch.Tensor,  # [B, A, H]
    emb: torch.Tensor,  # [B, A, A, lanes]
    ui: torch.Tensor,  # [B, A, 1] f32
    uj: torch.Tensor,  # [B, A, 1] f32
    wd: torch.Tensor,  # [lanes, H]
    w1: torch.Tensor,  # [H, H]
    b1: torch.Tensor,  # [H] or [1, H]
    *,
    bcast: bool = True,
    agg: bool = True,
) -> torch.Tensor:
    """The 4-D edge kernels' function from the embedding on, in plain
    PyTorch: ``s = silu(silu(emb @ w_d [+ t_i + t_j]) @ w_1 + b_1)``, then
    ``u_i sum_j s_ij u_j`` (``agg``) or the j-slice ``u_i s_{i, 0}``.

    The products run in f32 on operands rounded to the compute dtype (the
    dtype of ``term_i``), as the kernel computes them; the elementwise chain
    and the j-sum stay in f32.
    """
    cdt = term_i.dtype
    f32 = torch.float32
    e = emb.to(cdt).to(f32) @ wd.to(f32)
    if bcast:
        e = e + term_i.to(f32)[:, :, None, :] + term_j.to(f32)[:, None, :, :]
    e = torch.nn.functional.silu(e).to(cdt).to(f32)
    s = torch.nn.functional.silu(e @ w1.to(f32) + b1.to(f32).reshape(-1))
    if agg:
        out = torch.sum(s * uj.to(f32)[:, None, :, :], dim=2)  # [B, A, H]
    else:
        out = s[:, :, 0, :]
    return (out * ui.to(f32)).to(cdt)


def fused_edge_chain_plain(
    term_i: torch.Tensor,  # [B, A, H] incl. lattice term and edge_mlp_0 bias
    term_j: torch.Tensor,  # [B, A, H]
    frac_coords: torch.Tensor,  # [B, A, 3] f32
    ui: torch.Tensor,  # [B, A, 1] f32: mask_i / denom_i
    uj: torch.Tensor,  # [B, A, 1] f32: mask_j
    wd: torch.Tensor,  # [6 nf, H] Fourier slice of edge_mlp_0 (in, out)
    w1: torch.Tensor,  # [H, H] edge_mlp_1 (in, out)
    b1: torch.Tensor,  # [H]
    *,
    num_freqs: int = 10,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the decomposed edge math of
    ``matinvent_tpu/models/cspnet.py:174-195``, with the kernel's phase
    constants (``phase_consts``)."""
    fmat = _phase_table(num_freqs, frac_coords.device)
    emb = phase_embedding(frac_coords, fmat, 3 * num_freqs)
    return edge_chain_plain(term_i, term_j, emb, ui, uj, wd, w1, b1)


def check_tensors(expect, device: torch.device) -> None:
    """Raise unless each ``(name, tensor, shape, dtype)`` of ``expect`` has
    that shape and dtype, lies on ``device``, is contiguous and 16-byte
    aligned: what the CUDA kernels take."""
    for name, t, shape, dtype in expect:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {device}, current CUDA device is {torch.cuda.current_device()}"
        )


@functools.cache
def _launch_fn():
    """The kernels' C launch function, built and bound on first use."""
    from matinvent_tpu_torch.csrc.build import build

    fn = build("fused_edge").lib.fused_edge_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_edge_kernel(
    mode: str, term_i, term_j, frac_coords, fmat, de, ui, uj, wd, w1, b1, *, n_sin: int
) -> torch.Tensor:
    """Launch ``csrc/fused_edge.cu`` in ``mode`` (one of ``MODES``) on tensors
    the caller has checked; ``frac_coords``/``fmat`` or ``de`` may be None
    where the mode does not read them. The j-slice modes keep row j = 0,
    passed to the kernel at run time so that it computes every row's
    products. Returns the ``[B, A, H]`` output."""
    B, A, H = term_i.shape
    out = torch.empty_like(term_i)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _launch_fn()(
        MODES.index(mode), ptr(term_i), ptr(term_j), ptr(frac_coords), ptr(fmat),
        ptr(de), ptr(ui), ptr(uj), ptr(wd), ptr(w1), ptr(b1), ptr(out),
        B, A, H, wd.shape[0], n_sin, 0, _DTYPE_CODE[term_i.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_edge_launch ({mode}) failed: cudaError {err}")
    return out


def tiled(hidden: int, cap: int, lanes: int) -> bool:
    """Whether a tiled instance of ``csrc/fused_edge.cu`` takes the shape
    (``fused_edge_launch`` decides the same way); else the wide route runs."""
    return hidden in _HIDDEN and cap <= _MAX_ATOMS and lanes <= _MAX_LANES


def wide_smem_bytes(hidden: int, lanes: int) -> int:
    """Dynamic shared memory of one block of the wide route, as
    ``csrc/fused_edge.cu``'s ``WideSmem`` lays it out (f32): the embedding
    tile [64, Kd + 4] (later the j-sum's 32 staging rows [32, 136]), e [64,
    Hp + 4], two staged weight tiles [16, 136], one running sum per column
    and the phase constants [3, lanes]; Kd is ``lanes`` and Hp the width
    rounded up to 16 and 128."""
    kd, hp = round_up(lanes, 16), round_up(hidden, 128)
    return 4 * (max(64 * (kd + 4), 32 * 136) + 64 * (hp + 4) + 2 * 16 * 136 + hp + 3 * lanes)


def _refusal(hidden: int, cap: int, num_freqs: int, dtype: torch.dtype) -> str | None:
    """Why ``csrc/fused_edge.cu`` cannot take this shape, or None."""
    if dtype not in _DTYPE_CODE:
        return f"compute dtype must be float32 or bfloat16, got {dtype}"
    if hidden < 1 or cap < 1 or num_freqs < 1:
        return f"width, atoms and num_freqs must be positive, got {hidden}, {cap}, {num_freqs}"
    lanes = 6 * num_freqs
    if tiled(hidden, cap, lanes):
        return None
    need = wide_smem_bytes(hidden, lanes) + _WIDE_STATIC
    if need > _SMEM_OPTIN:
        return (f"width {hidden} with {num_freqs} frequencies needs {need} bytes of shared "
                f"memory per block, more than the {_SMEM_OPTIN} a block can have")
    return None


def kernel_takes(hidden: int, cap: int, num_freqs: int, dtype: torch.dtype) -> bool:
    """Whether the edge kernel takes a layer of width ``hidden`` over
    crystals padded to ``cap`` atoms with ``num_freqs`` Fourier frequencies
    in ``dtype``: the one rule ``fused_edge_chain`` enforces on CUDA, a
    pure function of the shape. Any atom count and any width up to the
    wide route's shared memory (``wide_smem_bytes``; 640 at 10
    frequencies) in float32 or bfloat16."""
    return _refusal(hidden, cap, num_freqs, dtype) is None


def _check(term_i, term_j, frac_coords, ui, uj, wd, w1, b1, num_freqs):
    if term_i.dim() != 3:
        raise ValueError(f"term_i must be [B, A, H], got {tuple(term_i.shape)}")
    B, A, H = term_i.shape
    cdt = term_i.dtype
    why = _refusal(H, A, num_freqs, cdt)
    if why is not None:
        raise ValueError(why)
    check_tensors([
        ("term_i", term_i, (B, A, H), cdt),
        ("term_j", term_j, (B, A, H), cdt),
        ("frac_coords", frac_coords, (B, A, 3), torch.float32),
        ("ui", ui, (B, A, 1), torch.float32),
        ("uj", uj, (B, A, 1), torch.float32),
        ("wd", wd, (6 * num_freqs, H), cdt),
        ("w1", w1, (H, H), cdt),
        ("b1", b1, (H,), cdt),
    ], term_i.device)


def fused_edge_chain(
    term_i: torch.Tensor,
    term_j: torch.Tensor,
    frac_coords: torch.Tensor,
    ui: torch.Tensor,
    uj: torch.Tensor,
    wd: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    *,
    num_freqs: int = 10,
) -> torch.Tensor:
    """Aggregated edge messages ``[B, A, H]`` of one fc CSPLayer.

    Arguments as in ``fused_edge_chain_plain``; ``term_i``, ``term_j``,
    ``wd``, ``w1``, ``b1`` and the output are in the compute dtype (float32
    or bfloat16). On CUDA every tensor must be contiguous on one device;
    anything the kernel does not take raises. The launch is asynchronous on
    the current stream; ``fused_edge_chain.launches`` counts the launches
    of either route.
    """
    if term_i.device.type == "cpu":
        return fused_edge_chain_plain(
            term_i, term_j, frac_coords, ui, uj, wd, w1, b1, num_freqs=num_freqs
        )
    _check(term_i, term_j, frac_coords, ui, uj, wd, w1, b1, num_freqs)
    out = launch_edge_kernel(
        "full", term_i, term_j, frac_coords, _phase_table(num_freqs, term_i.device),
        None, ui, uj, wd, w1, b1, n_sin=3 * num_freqs,
    )
    fused_edge_chain.launches += 1
    return out


fused_edge_chain.launches = 0
