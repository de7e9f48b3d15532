"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA card. On the card machine, which has no JAX, run
them without the repository's conftest (it imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

This file imports torch, numpy and the port only.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from matinvent_tpu_torch.experiments import fused_edge_ab, fused_edge_flat
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
)
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain, fused_edge_chain_plain

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(B, A, H, nf, dtype, seed=0):
    rng = np.random.default_rng(seed)
    na = rng.integers(1, A + 1, (B,))
    mask = np.arange(A)[None, :] < na[:, None]

    def t(x, dt=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dt, device="cuda")

    args = (
        t(rng.normal(size=(B, A, H)), dtype), t(rng.normal(size=(B, A, H)), dtype),
        t(rng.uniform(size=(B, A, 3))),
        t((mask / na[:, None])[..., None]), t(mask[..., None]),
        t(rng.normal(size=(6 * nf, H)) * 0.1, dtype),
        t(rng.normal(size=(H, H)) * 0.1, dtype), t(rng.normal(size=(H,)) * 0.1, dtype),
    )
    return args, torch.tensor(mask, device="cuda")


# (B, A, H, nf): narrow test widths, a single atom, the 64-atom limit and the
# sampler's bucket caps at H=256 (A=20 and 12 leave a short last row block),
# then every width at the odd caps, and single-crystal buckets
SHAPES = [(5, 4, 32, 3), (7, 8, 64, 10), (3, 1, 128, 10), (2, 64, 32, 10),
          (11, 8, 256, 10), (6, 12, 256, 10), (5, 16, 256, 10), (9, 20, 256, 10)]
SHAPES += [(5, A, H, 10) for A in (1, 2, 3, 13, 20, 64) for H in (32, 64, 128, 256)]
SHAPES += [(1, 1, 256, 10), (1, 20, 256, 10), (1, 64, 128, 10), (1, 3, 32, 4)]
# f32: summation order only; bf16: e is rounded to bf16 before the second
# product, and one flipped rounding moves an output by about one bf16 step
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,A,H,nf", SHAPES)
def test_kernel_matches_plain(B, A, H, nf, dtype):
    _need_card()
    args, mask = _inputs(B, A, H, nf, dtype)
    before = fused_edge_chain.launches
    out = fused_edge_chain(*args, num_freqs=nf)
    torch.cuda.synchronize()
    assert fused_edge_chain.launches == before + 1
    ref = fused_edge_chain_plain(*args, num_freqs=nf)
    scale = max(1.0, ref.float().abs().max().item())
    assert out.dtype == dtype and out.shape == (B, A, H)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype] * scale
    assert bool((out[~mask] == 0).all())


# persistent blocks walk the tiles: fewer tiles than resident blocks, about
# as many, and many more (at A=20 a tile holds 3 rows i, at A=8 8 rows i)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,A", [(7, 20), (19, 20), (131, 8), (1200, 20), (3000, 8)])
def test_kernel_splits_tiles_over_persistent_blocks(B, A, dtype):
    _need_card()
    args, mask = _inputs(B, A, 256, 10, dtype, seed=B)
    out = fused_edge_chain(*args, num_freqs=10)
    torch.cuda.synchronize()
    ref = fused_edge_chain_plain(*args, num_freqs=10)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype] * scale
    assert bool((out[~mask] == 0).all())
    # the j-sum is taken in a fixed order: a second launch agrees bit for bit
    again = fused_edge_chain(*args, num_freqs=10)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    args, _ = _inputs(2, 4, 32, 3, torch.float32)
    with pytest.raises(ValueError):  # mixed compute dtypes
        fused_edge_chain(args[0], args[1].half(), *args[2:], num_freqs=3)
    with pytest.raises(ValueError):  # non-contiguous term
        fused_edge_chain(args[0].transpose(0, 1), *args[1:], num_freqs=3)
    with pytest.raises(ValueError):  # width the kernel has no instance for
        a, _ = _inputs(2, 4, 48, 3, torch.float32)
        fused_edge_chain(*a, num_freqs=3)


def test_score_net_kernel_matches_plain_on_card():
    _need_card()
    torch.manual_seed(0)
    model = MatterGenDiffusion(
        MatterGenConfig(hidden_dim=64, num_layers=2, time_dim=32, timesteps=16),
        device="cuda",
    )
    B, A = 6, 12
    g = torch.Generator(device="cuda").manual_seed(0)
    na = torch.randint(1, A + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(A, device="cuda")[None] < na[:, None]
    noised = MGNoised(
        torch.full((B,), 0.5, device="cuda"),
        torch.randn((B, 32), generator=g, device="cuda"),
        torch.randint(0, 100, (B, A), generator=g, device="cuda"),
        torch.rand((B, A, 3), generator=g, device="cuda"),
        torch.eye(3, device="cuda")[None] * 3 + 0.1 * torch.randn((B, 3, 3), generator=g, device="cuda"),
    )
    with torch.no_grad():
        fused = model.apply_net(noised, na, mask, fused_edge=True)
        plain = model.apply_net(noised, na, mask, fused_edge=False)
    for k in plain:
        torch.testing.assert_close(fused[k], plain[k], atol=2e-4, rtol=0, msg=k)


def test_sampling_on_card_launches_the_kernel():
    _need_card()
    torch.manual_seed(0)
    cfg = MatterGenConfig(hidden_dim=32, num_layers=2, time_dim=16, timesteps=5)
    model = MatterGenDiffusion(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    fused_edge_chain.launches = 0
    outs = model.sample_bucketed(
        g, [torch.tensor([1, 3, 4]), torch.tensor([6, 8])], [4, 8]
    )
    torch.cuda.synchronize()
    assert fused_edge_chain.launches == 2 * 2 * 5 * 2  # layers x evals x steps x buckets
    for o, cap in zip(outs, (4, 8)):
        assert o.frac_coords.shape[1] == cap
        assert torch.isfinite(o.lattice).all()


# (crystals, cap) of the harness kernels: odd shapes, a single atom, the
# 64-atom limit and the harnesses' full width (bench.py's dominant bucket)
HARNESS_SHAPES = [(7, 13), (3, 1), (2, 64), (203, 20), (1, 20), (5, 2), (4, 3)]


def _close(out, ref, mask=None):
    scale = max(1.0, ref.float().abs().max().item())
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[out.dtype] * scale
    if mask is not None:
        assert bool((out[~mask] == 0).all())


def _mask(na, atoms):
    return torch.tensor(np.arange(atoms)[None, :] < na[:, None], device="cuda")


@pytest.mark.parametrize("mode", fused_edge_ab.ABLATIONS)
@pytest.mark.parametrize("crystals,atoms", HARNESS_SHAPES)
def test_edge_variant_matches_plain(mode, crystals, atoms):
    _need_card()
    args, na = fused_edge_ab.make_inputs(np.random.default_rng(atoms), crystals, atoms, "cuda")
    before = fused_edge_ab.edge_variant.launches
    out = fused_edge_ab.edge_variant(mode, *args)
    torch.cuda.synchronize()
    assert fused_edge_ab.edge_variant.launches == before + 1
    _close(out, fused_edge_ab.edge_variant_plain(mode, *args), _mask(na, atoms))


@pytest.mark.parametrize("crystals,atoms", HARNESS_SHAPES)
def test_flat_and_demb_match_plain(crystals, atoms):
    _need_card()
    flat, demb, na = fused_edge_flat.make_inputs(
        np.random.default_rng(atoms), crystals, atoms, "cuda"
    )
    n_flat, n_demb = fused_edge_flat.flat_edge_mlp.launches, fused_edge_flat.demb_edge.launches
    out_flat = fused_edge_flat.flat_edge_mlp(*flat)
    out_demb = fused_edge_flat.demb_edge(*demb)
    torch.cuda.synchronize()
    assert fused_edge_flat.flat_edge_mlp.launches == n_flat + 1
    assert fused_edge_flat.demb_edge.launches == n_demb + 1
    _close(out_flat, fused_edge_flat.flat_edge_mlp_plain(*flat))
    _close(out_demb, fused_edge_flat.demb_edge_plain(*demb), _mask(na, atoms))


def test_full_variant_is_the_sampler_kernel_on_card():
    # mode "full" launches the sampler's instance: with w_d's rows past 6 nf
    # zero, its dead lanes (cos 0 = 1) add exact zeros, so the two agree
    # bit for bit
    _need_card()
    args, _ = fused_edge_ab.make_inputs(np.random.default_rng(0), 9, 20, "cuda")
    ti, tj, fr, ui, uj, fmat, wd, w1, b1 = args
    wd = wd.clone()
    wd[60:] = 0
    out = fused_edge_ab.edge_variant("full", ti, tj, fr, ui, uj, fmat, wd, w1, b1)
    ref = fused_edge_chain(ti, tj, fr, ui, uj, wd[:60].contiguous(), w1, b1[0].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_harness_kernels_reject_what_they_do_not_take():
    _need_card()
    args, _ = fused_edge_ab.make_inputs(np.random.default_rng(0), 2, 4, "cuda")
    with pytest.raises(ValueError):  # the ablations exist in bf16 only
        fused_edge_ab.edge_variant("nosin", args[0].float(), *args[1:])
    with pytest.raises(ValueError):  # unknown mode
        fused_edge_ab.edge_variant("nope", *args)
    flat, demb, _ = fused_edge_flat.make_inputs(np.random.default_rng(0), 2, 4, "cuda")
    with pytest.raises(ValueError):  # rows of ts and emb differ
        fused_edge_flat.flat_edge_mlp(flat[0][:-1].contiguous(), *flat[1:])
    with pytest.raises(ValueError):  # embedding of the wrong cap
        fused_edge_flat.demb_edge(demb[0], demb[1], demb[2][:, :3].contiguous(), *demb[3:])


def _chunk_inputs(model, na, A, C, seed):
    """A padded batch with atom counts ``na``, rewards and ``C`` timesteps'
    draws, all from numpy."""
    from matinvent_tpu_torch.models.batch import CrystalBatch
    from matinvent_tpu_torch.models.mattergen.diffusion import NoiseDraws

    rng = np.random.default_rng(seed)
    B = len(na)
    mask = np.arange(A)[None, :] < np.asarray(na)[:, None]
    batch = CrystalBatch(
        torch.tensor(np.where(mask, rng.integers(1, 101, (B, A)), 0), dtype=torch.int32),
        torch.tensor(rng.uniform(size=(B, A, 3)) * mask[..., None], dtype=torch.float32),
        torch.tensor(np.eye(3) * 5 + rng.normal(size=(B, 3, 3)), dtype=torch.float32),
        torch.tensor(na, dtype=torch.int32),
    )
    draws = NoiseDraws(
        torch.tensor(rng.normal(size=(C, B, 3, 3)), dtype=torch.float32),
        torch.tensor(rng.normal(size=(C, B, A, 3)), dtype=torch.float32),
        torch.tensor(rng.gumbel(size=(C, B, A, model.d3pm.vocab)), dtype=torch.float32),
    )
    return batch, torch.tensor(rng.uniform(size=B), dtype=torch.float32), draws


def test_chunk_loss_and_gradients_on_card_match_cpu_at_odd_atom_counts():
    """The fine-tune's chunk on the card against the same code on the CPU,
    at odd atom counts: only the summation order differs, so the loss and
    every gradient agree within 1e-4 of their scale."""
    _need_card()
    torch.manual_seed(1)
    cfg = MatterGenConfig(hidden_dim=64, num_layers=2, time_dim=32, timesteps=20)
    cpu, prior_cpu = (MatterGenDiffusion(cfg, device="cpu") for _ in range(2))
    card, prior_card = (MatterGenDiffusion(cfg, device="cuda") for _ in range(2))
    card.load_state_dict(cpu.state_dict())
    prior_card.load_state_dict(prior_cpu.state_dict())
    t_idx = torch.arange(5, 10)
    batch, rewards, draws = _chunk_inputs(cpu, [1, 13, 7, 3, 11], 13, len(t_idx), seed=2)
    results = []
    for model, prior, dev in ((cpu, prior_cpu, "cpu"), (card, prior_card, "cuda")):
        loss, _ = model.rl_chunk_loss(
            prior, batch.to(dev), rewards.to(dev), t_idx.to(dev), 0.1,
            draws=type(draws)(*(d.to(dev) for d in draws)),
        )
        loss.backward()
        results.append((loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (l_cpu, g_cpu), (l_card, g_card) = results
    assert abs(l_card - l_cpu) <= 1e-4 * max(1.0, abs(l_cpu))
    for k, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-12)
        assert (g_card[k] - g).abs().max().item() <= 1e-4 * scale, k


def test_geometry_products_ignore_tf32():
    """With TF32 allowed for matmuls, the cell Gram matrix and the cell
    score's right coupling still equal their float64 result rounded to f32."""
    _need_card()
    from matinvent_tpu_torch.models.cspnet import matmul3

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g = torch.Generator(device="cuda").manual_seed(0)
        lat = 4.0 * torch.eye(3, device="cuda") + torch.randn((256, 3, 3), generator=g, device="cuda")
        sym = torch.randn((256, 3, 3), generator=g, device="cuda")
        for a, b in ((lat, lat.transpose(-1, -2)), (sym, lat)):
            ref = (a.double() @ b.double()).float()
            assert torch.equal(matmul3(a, b), ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_native_charge_balance_builds_and_agrees_on_the_card_machine():
    _need_card()
    from matinvent_tpu_torch.chem.data import ELECTRONEGATIVITY, OXIDATION_STATES
    from matinvent_tpu_torch.chem.validity import charge_balanced, charge_balanced_plain

    rng = np.random.default_rng(0)
    syms = sorted(s for s, ox in OXIDATION_STATES.items() if ox)
    for _ in range(2000):
        el = list(rng.choice(syms, int(rng.integers(2, 5)), replace=False))
        counts = [int(c) for c in rng.integers(1, 7, len(el))]
        args = ([OXIDATION_STATES[s] for s in el], counts, [ELECTRONEGATIVITY.get(s) for s in el])
        assert charge_balanced(*args) == charge_balanced_plain(*args), (el, counts)
