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
terms), so the kernel keeps the ``[A^2, H]`` intermediates in shared memory
and registers and streams the weights from L2; see the source for its
layout. On a CPU tensor the wrapper runs ``fused_edge_chain_plain``, the same
math in plain PyTorch; a CUDA tensor never takes the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HIDDEN = (32, 64, 128, 256)
_MAX_ATOMS = 64  # edge rows of one crystal row fit one 64-row block
_MAX_LANES = 64  # 6 * num_freqs lanes of the Fourier embedding


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
    ``matinvent_tpu/models/cspnet.py:174-195``.

    The products run in f32 on operands rounded to the compute dtype (the
    dtype of ``term_i``), as the kernel computes them; the elementwise chain
    and the j-sum stay in f32.
    """
    from matinvent_tpu_torch.models.cspnet import sinusoids_embedding

    cdt = term_i.dtype
    f32 = torch.float32
    fr = frac_coords.to(f32)
    fd = (fr[:, None, :, :] - fr[:, :, None, :]) % 1.0  # [B, A, A, 3]
    emb = sinusoids_embedding(fd, num_freqs).to(cdt).to(f32)
    e = emb @ wd.to(f32)
    e = e + term_i.to(f32)[:, :, None, :] + term_j.to(f32)[:, None, :, :]
    e = torch.nn.functional.silu(e).to(cdt).to(f32)
    s = torch.nn.functional.silu(e @ w1.to(f32) + b1.to(f32))
    agg = torch.sum(s * uj.to(f32)[:, None, :, :], dim=2)  # [B, A, H]
    return (agg * ui.to(f32)).to(cdt)


def _check(term_i, term_j, frac_coords, ui, uj, wd, w1, b1, num_freqs):
    if term_i.dim() != 3:
        raise ValueError(f"term_i must be [B, A, H], got {tuple(term_i.shape)}")
    B, A, H = term_i.shape
    cdt = term_i.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {cdt}")
    if H not in _HIDDEN:
        raise ValueError(f"hidden width must be one of {_HIDDEN}, got {H}")
    if not 1 <= A <= _MAX_ATOMS:
        raise ValueError(f"atoms per crystal must be in 1..{_MAX_ATOMS}, got {A}")
    if not 1 <= 6 * num_freqs <= _MAX_LANES:
        raise ValueError(f"num_freqs must be in 1..{_MAX_LANES // 6}, got {num_freqs}")
    expect = [
        ("term_i", term_i, (B, A, H), cdt),
        ("term_j", term_j, (B, A, H), cdt),
        ("frac_coords", frac_coords, (B, A, 3), torch.float32),
        ("ui", ui, (B, A, 1), torch.float32),
        ("uj", uj, (B, A, 1), torch.float32),
        ("wd", wd, (6 * num_freqs, H), cdt),
        ("w1", w1, (H, H), cdt),
        ("b1", b1, (H,), cdt),
    ]
    dev = term_i.device
    for name, t, shape, dtype in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype} != {dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, term_i on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@functools.cache
def _launch_fn():
    """The kernel's C launch function, built and bound on first use."""
    from matinvent_tpu_torch.csrc.build import build

    fn = build("fused_edge").lib.fused_edge_chain_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    the current stream; ``fused_edge_chain.launches`` counts the launches.
    """
    if term_i.device.type == "cpu":
        return fused_edge_chain_plain(
            term_i, term_j, frac_coords, ui, uj, wd, w1, b1, num_freqs=num_freqs
        )
    if term_i.device.type != "cuda":
        raise ValueError(f"unsupported device {term_i.device}")
    _check(term_i, term_j, frac_coords, ui, uj, wd, w1, b1, num_freqs)
    if term_i.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors on {term_i.device}, current CUDA device is "
            f"{torch.cuda.current_device()}"
        )
    B, A, H = term_i.shape
    out = torch.empty_like(term_i)
    err = _launch_fn()(
        term_i.data_ptr(), term_j.data_ptr(), frac_coords.data_ptr(),
        ui.data_ptr(), uj.data_ptr(), wd.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), out.data_ptr(),
        B, A, H, num_freqs, _DTYPE_CODE[term_i.dtype],
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_edge_chain launch failed: cudaError {err}")
    fused_edge_chain.launches += 1
    return out


fused_edge_chain.launches = 0
