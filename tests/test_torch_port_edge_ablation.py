"""The port's fused-edge harnesses against the JAX harnesses, on the CPU.

The same numpy-seeded inputs go through each Pallas kernel of
``experiments/fused_edge_ab_r5.py`` and ``experiments/fused_edge_flat_r5.py``
(run in interpret mode: their ``make_*`` builders take no ``interpret``
argument, so ``pallas_call`` is patched to interpret for the test) and
through the port's counterparts in ``matinvent_tpu_torch.experiments``,
whose wrappers run their plain versions on CPU tensors. The harnesses fix
H = 256 and 64 embedding lanes; the tests shrink only the batch.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matinvent_tpu_torch.experiments import fused_edge_ab, fused_edge_flat
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain_plain, phase_consts

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H, DP, NF = 256, 64, 10
# bf16 outputs: one rounding step of the largest output
TOL = 2.0**-7


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_ab():
    return _load("fused_edge_ab_r5")


@pytest.fixture(scope="module")
def jax_flat():
    return _load("fused_edge_flat_r5")


@pytest.fixture
def interpret(monkeypatch):
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(
        jax.experimental.pallas, "pallas_call", functools.partial(orig, interpret=True)
    )


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, held as f32 (exact in both frameworks)."""
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _pair(arrays, dtypes):
    """The same arrays as JAX arrays and torch tensors of the given dtypes."""
    jx = [jnp.asarray(a, jnp.bfloat16 if d == torch.bfloat16 else jnp.float32)
          for a, d in zip(arrays, dtypes)]
    tt = [torch.from_numpy(a).to(d) for a, d in zip(arrays, dtypes)]
    return jx, tt


def _edge_inputs(B, A, seed, scale=1.0):
    """Inputs of the 4-D kernels: ti, tj, fr, ui, uj, fmat, wd, w1, b1 and
    the row mask; atom counts 1..A with one full crystal."""
    rng = np.random.default_rng(seed)
    na = rng.integers(1, A + 1, (B,))
    na[0] = A
    mask = np.arange(A)[None, :] < na[:, None]
    arrays = [
        _bf16(rng.normal(size=(B, A, H)) * scale),
        _bf16(rng.normal(size=(B, A, H)) * scale),
        rng.uniform(size=(B, A, 3)).astype(np.float32),
        (mask / na[:, None]).astype(np.float32)[..., None],
        mask.astype(np.float32)[..., None],
        phase_consts(NF, DP),
        _bf16(rng.normal(size=(DP, H)) * 0.05),
        _bf16(rng.normal(size=(H, H)) * 0.05),
        _bf16(rng.normal(size=(1, H)) * 0.05),
    ]
    bf, f32 = torch.bfloat16, torch.float32
    jx, tt = _pair(arrays, [bf, bf, f32, f32, f32, f32, bf, bf, bf])
    return jx, tt, mask


def _assert_close(out: torch.Tensor, ref, what: str, mask=None):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    tol = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: max |err| {err} > {tol}"
    if mask is not None:
        assert np.all(out[~mask] == 0.0), f"{what}: padded rows not exactly 0"


@pytest.mark.parametrize("mode", fused_edge_ab.ABLATIONS)
def test_edge_variant_plain_matches_pallas(mode, jax_ab, interpret):
    # 3 crystals of cap 5, 2 crystals per Pallas block: the block divides
    # neither B nor the grid evenly
    jx, tt, mask = _edge_inputs(3, 5, seed=0, scale=0.2)
    call, G = jax_ab.make_call(3, 5, 50, mode)
    assert G == 2
    ref = call(*jx)
    before = fused_edge_ab.edge_variant.launches
    out = fused_edge_ab.edge_variant(mode, *tt)
    assert fused_edge_ab.edge_variant.launches == before  # the CPU takes the plain version
    _assert_close(out, ref, mode, mask)


def test_flat_edge_mlp_plain_matches_pallas(jax_flat, interpret):
    R, blk = 150, 64  # R not a multiple of the block
    rng = np.random.default_rng(1)
    arrays = [
        _bf16(rng.normal(size=(R, H)) * 0.1),
        _bf16(rng.normal(size=(R, DP)) * 0.5),
        _bf16(rng.normal(size=(DP, H)) * 0.05),
        _bf16(rng.normal(size=(H, H)) * 0.05),
        _bf16(rng.normal(size=(1, H)) * 0.05),
    ]
    jx, tt = _pair(arrays, [torch.bfloat16] * 5)
    ref = jax_flat.make_flat(R, blk)(*jx)
    before = fused_edge_flat.flat_edge_mlp.launches
    out = fused_edge_flat.flat_edge_mlp(*tt)
    assert fused_edge_flat.flat_edge_mlp.launches == before
    _assert_close(out, ref, "flat")


def test_demb_edge_plain_matches_pallas(jax_flat, interpret):
    B, A = 3, 5
    jx, tt, mask = _edge_inputs(B, A, seed=2, scale=0.2)
    rng = np.random.default_rng(3)
    de = _bf16(rng.normal(size=(B, A, A, DP)) * 0.5)
    (jde,), (tde,) = _pair([de], [torch.bfloat16])
    # demb takes (ti, tj, de, ui, uj, wd, w1, b1): no coords, no fmat
    ref = jax_flat.make_demb(B, A, 50)(jx[0], jx[1], jde, jx[3], jx[4], *jx[6:])
    before = fused_edge_flat.demb_edge.launches
    out = fused_edge_flat.demb_edge(tt[0], tt[1], tde, tt[3], tt[4], *tt[6:])
    assert fused_edge_flat.demb_edge.launches == before
    _assert_close(out, ref, "demb", mask)


def test_torch_chain_matches_xla_chain(jax_ab):
    jx, tt, mask = _edge_inputs(4, 6, seed=4, scale=0.1)
    ref = jax_ab.xla_chain(*jx)
    out = fused_edge_ab.torch_chain(*tt)
    assert out.dtype == torch.bfloat16
    _assert_close(out, ref, "torch_chain", mask)


def test_torch_flat_chain_matches_flat_xla(jax_flat):
    R = 100
    rng = np.random.default_rng(5)
    arrays = [
        _bf16(rng.normal(size=(R, H)) * 0.1),
        _bf16(rng.normal(size=(R, DP)) * 0.5),
        _bf16(rng.normal(size=(DP, H)) * 0.05),
        _bf16(rng.normal(size=(H, H)) * 0.05),
        _bf16(rng.normal(size=(1, H)) * 0.05),
    ]
    jx, tt = _pair(arrays, [torch.bfloat16] * 5)
    out = fused_edge_flat.torch_flat_chain(*tt)
    assert out.dtype == torch.bfloat16
    _assert_close(out, jax_flat.flat_xla(*jx), "torch_flat_chain")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_variant_is_the_sampler_kernel(dtype):
    # with w_d's rows past 6 nf zero, the harness's "full" mode computes the
    # sampler's edge chain exactly: its dead lanes cos(0) = 1 meet zero rows
    _, tt, _ = _edge_inputs(4, 7, seed=6)
    ti, tj, fr, ui, uj, fmat, wd, w1, b1 = tt
    ti, tj, wd, w1, b1 = (t.to(dtype) for t in (ti, tj, wd, w1, b1))
    wd[6 * NF:] = 0
    out = fused_edge_ab.edge_variant_plain("full", ti, tj, fr, ui, uj, fmat, wd, w1, b1)
    ref = fused_edge_chain_plain(
        ti, tj, fr, ui, uj, wd[: 6 * NF].contiguous(), w1, b1[0], num_freqs=NF
    )
    assert torch.equal(out, ref)


AB_KEYS = {"harness", "device", "crystals", "atoms", "H", "lanes", "dtype", "edge_rows",
           "iters", "geometry", "pairs", "flops", "bytes", "bound_ms", "bound_by",
           "modes", "torch_chain_ms"}
FLAT_KEYS = {"harness", "device", "crystals", "atoms", "R", "H", "lanes", "dtype",
             "iters", "flat", "demb"}
PART_KEYS = {"max_abs_err", "ms", "plain_ms", "torch_chain_ms", "geometry", "flops",
             "bytes", "bound_ms", "bound_by"}


@pytest.mark.parametrize("harness", ["fused_edge_ab", "fused_edge_flat"])
def test_harness_main_on_cpu_prints_its_record(harness, capsys):
    mod = {"fused_edge_ab": fused_edge_ab, "fused_edge_flat": fused_edge_flat}[harness]
    rec = mod.main(device="cpu", crystals=3, atoms=4, iters=1)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rec and rec["harness"] == harness and rec["device"] == "cpu"
    if harness == "fused_edge_ab":
        assert set(rec) == AB_KEYS
        assert set(rec["modes"]) == set(fused_edge_ab.ABLATIONS)
        parts = rec["modes"].values()
        assert rec["edge_rows"] == 3 * 16 and rec["bound_by"] in ("bytes", "operations")
    else:
        assert set(rec) == FLAT_KEYS and rec["R"] == 3 * 16
        parts = [rec["flat"], rec["demb"]]
        for part in parts:
            assert PART_KEYS <= set(part)
    for part in parts:
        # the CPU runs the plain versions and measures no time
        assert part["max_abs_err"] == 0.0
        assert part["ms"] is None and part["plain_ms"] is None


@pytest.mark.parametrize("harness", ["fused_edge_ab", "fused_edge_flat"])
def test_harness_main_needs_a_card_unless_asked_for_the_cpu(harness):
    mod = {"fused_edge_ab": fused_edge_ab, "fused_edge_flat": fused_edge_flat}[harness]
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs there")
    with pytest.raises(RuntimeError):
        mod.main(crystals=1, atoms=1, iters=1)
