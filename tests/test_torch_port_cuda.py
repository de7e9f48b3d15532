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
from matinvent_tpu_torch.experiments.phonon_check import phonon_pair, rocksalt
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
)
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain, fused_edge_chain_plain, tiled
from matinvent_tpu_torch.rewards.calculators.predictor import (
    DEFAULT_MODEL_DIR,
    TASK_MODEL_DICT,
    PropertyGNN,
)

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
# the wide route: h384 and h512, caps above 64 atoms (one crystal row over
# two and three chunks), widths of no tiled instance (odd ones too), more
# than 10 frequencies, and the widest width it takes at 10 in f32; then
# packed chunks (several crystal rows of 65-72 atoms, whose rows i cross
# the chunk boundaries, cap 128, and a bucket of many small crystals at
# h384) and the layouts past the 128-row chunks (88 frequencies at h256:
# 64-row chunks in bf16, 8-row weight tiles in f32)
WIDE_SHAPES = [(3, 20, 384, 10), (1, 1, 384, 10), (2, 65, 384, 10), (5, 13, 512, 10),
               (2, 72, 256, 10), (2, 130, 64, 10), (3, 129, 32, 3), (4, 20, 48, 10),
               (3, 8, 100, 11), (2, 7, 33, 2), (6, 20, 256, 16), (2, 20, 640, 10),
               (6, 70, 256, 10), (5, 67, 384, 10), (3, 128, 64, 10), (200, 6, 384, 10),
               (2, 20, 256, 88)]
SHAPES += WIDE_SHAPES
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
    if not tiled(H, A, 6 * nf):
        # the wide route sums each row's j-sum in a fixed order: a second
        # launch agrees bit for bit
        again = fused_edge_chain(*args, num_freqs=nf)
        torch.cuda.synchronize()
        assert torch.equal(out, again)


# the wide route packs each crystal's live atoms (one past its last atom
# with u_i or u_j nonzero): atoms masked inside that prefix still run (times
# 0), a crystal with no atom writes only zeros; with more crystals than a
# block's table holds (256) every row runs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,A,H", [(9, 20, 384), (40, 70, 256), (300, 9, 48)])
def test_wide_route_packs_the_live_atoms(B, A, H, dtype):
    _need_card()
    args, mask = _inputs(B, A, H, 10, dtype, seed=7)
    rng = np.random.default_rng(B)
    keep = mask & torch.tensor(rng.uniform(size=(B, A)) > 0.2, device="cuda")
    keep[-1] = False
    na = keep.sum(1, keepdim=True).clamp(min=1).float()
    ui = (keep.float() / na)[..., None].contiguous()
    uj = keep.float()[..., None].contiguous()
    args = (*args[:3], ui, uj, *args[5:])
    out = fused_edge_chain(*args, num_freqs=10)
    torch.cuda.synchronize()
    ref = fused_edge_chain_plain(*args, num_freqs=10)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype] * scale
    assert bool((out[~keep] == 0).all())
    again = fused_edge_chain(*args, num_freqs=10)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


# bf16 keeps e at half the bytes of f32, so its wide route takes widths the
# f32 one refuses (64-row chunks past h640)
@pytest.mark.parametrize("B,A,H", [(3, 9, 1024), (2, 70, 1280)])
def test_wide_route_takes_wider_bf16_widths(B, A, H):
    _need_card()
    args, mask = _inputs(B, A, H, 10, torch.bfloat16)
    out = fused_edge_chain(*args, num_freqs=10)
    torch.cuda.synchronize()
    ref = fused_edge_chain_plain(*args, num_freqs=10)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16] * scale
    assert bool((out[~mask] == 0).all())
    with pytest.raises(ValueError):  # f32 needs twice the bytes for e
        a, _ = _inputs(B, A, H, 10, torch.float32)
        fused_edge_chain(*a, num_freqs=10)


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


# the wide route's work items over persistent blocks: few, about as many as
# resident blocks, many; short rows i packed into chunks, and rows of 72
# atoms crossing them; the buckets of chip_smoke.py's phase edge_shapes
# (7 x 8 and 25 x 20 at h384, 16 x 72 at h256)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,A,H", [(7, 20, 384), (400, 20, 384), (300, 72, 256), (40, 72, 384),
                                   (7, 8, 384), (25, 20, 384), (16, 72, 256)])
def test_wide_route_splits_items_over_persistent_blocks(B, A, H, dtype):
    _need_card()
    args, mask = _inputs(B, A, H, 10, dtype, seed=B)
    out = fused_edge_chain(*args, num_freqs=10)
    torch.cuda.synchronize()
    ref = fused_edge_chain_plain(*args, num_freqs=10)
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype] * scale
    assert bool((out[~mask] == 0).all())
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
    with pytest.raises(ValueError):  # wider than the wide route's shared memory
        a, _ = _inputs(2, 4, 641, 10, torch.float32)
        fused_edge_chain(*a, num_freqs=10)


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


def test_cuda_generator_state_round_trips_through_the_run_state():
    _need_card()
    from matinvent_tpu_torch.utils.checkpoint import generator_state, set_generator_state

    gen = torch.Generator(device="cuda").manual_seed(5)
    torch.rand(1000, generator=gen, device="cuda")
    text = generator_state(gen)
    expect = torch.randn(4096, generator=gen, device="cuda")
    fresh = torch.Generator(device="cuda").manual_seed(0)
    set_generator_state(fresh, text)
    assert torch.equal(torch.randn(4096, generator=fresh, device="cuda"), expect)


def test_resumed_matinvent_on_the_card_has_the_saved_weights(tmp_path):
    """One tiny iteration on the card saves its run state; a fresh
    ``MatInvent`` resumed from it holds the agent bit for bit, the sampler's
    CUDA generator state and the step after the saved one, and runs on."""
    _need_card()
    from matinvent_tpu_torch.pipeline import mat_invent
    from matinvent_tpu_torch.utils.checkpoint import generator_state

    tiny = [
        "model.model_path=null", "model.model_cfg.hidden_dim=32",
        "model.model_cfg.num_layers=2", "model.model_cfg.time_dim=16",
        "model.model_cfg.timesteps=10", "model.model_cfg.sample_clip=15.0",
        "model.finetune_cfg.timesteps=10", "pipeline.finetune_cfg.accum_steps=5",
        "pipeline.finetune_cfg.epochs=1", "model.sample_cfg.batch_size=6",
        "pipeline.sample_cfg.invalid_filter=false",
    ]
    first = mat_invent.build(mat_invent.resolve("rl_hhi_rich5", 1, tiny), str(tmp_path), "cuda")
    first.run_rl()
    resumed = mat_invent.build(
        mat_invent.resolve("rl_hhi_rich5", 2, [*tiny, "pipeline.resume=true"]), str(tmp_path), "cuda"
    )
    assert resumed._start_step == 1 and resumed.agent.device.type == "cuda"
    for k, v in first.agent.state_dict().items():
        assert torch.equal(resumed.agent.state_dict()[k], v), k
    assert generator_state(resumed.sampler._generator) == generator_state(first.sampler._generator)
    assert generator_state(resumed.generator) == generator_state(first.generator)
    resumed.run_rl()
    assert (tmp_path / "models/final/params.msgpack").is_file()


def _random_structures(counts, seed):
    """Crystals of the given atom counts: species 1..100, sheared cells."""
    from matinvent_tpu_torch.chem.structure import Structure

    rng = np.random.default_rng(seed)
    return [Structure(np.eye(3) * rng.uniform(3.0, 8.0) + rng.normal(size=(3, 3)) * 0.4,
                      rng.integers(1, 101, n), rng.uniform(size=(n, 3))) for n in counts]


# odd atom counts, and the predictors' 32-atom cap
PRED_COUNTS = [(1, 3, 7, 13, 31), (32, 32, 5), (17,)]


@pytest.mark.parametrize("counts", PRED_COUNTS)
def test_predictors_on_card_match_cpu(counts):
    """Each in-repo predictor on the card against the same weights on the
    CPU (TF32 off): within 1e-4 of its y_std."""
    _need_card()
    strucs = _random_structures(counts, seed=len(counts))
    for name in sorted(m for m in TASK_MODEL_DICT.values() if m):
        card = PropertyGNN(name, model_dir=DEFAULT_MODEL_DIR, device="cuda")
        cpu = PropertyGNN(name, model_dir=DEFAULT_MODEL_DIR, device="cpu")
        assert card.loaded and cpu.loaded
        out, ref = card.predict(strucs), cpu.predict(strucs)
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=1e-4 * card.y_std, rtol=0, err_msg=name)


def test_syn_score_on_card_matches_cpu(tmp_path):
    _need_card()
    from matinvent_tpu_torch.rewards.calculators.syn_score import SynScore

    strucs = _random_structures([1, 2, 3, 5, 8, 13, 32] * 10, seed=3)
    card = SynScore(str(tmp_path / "card"), device="cuda")
    cpu = SynScore(str(tmp_path / "cpu"), device="cpu")
    assert card.trained and cpu.trained
    np.testing.assert_allclose(card.calc((strucs, None)), cpu.calc((strucs, None)), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("counts", PRED_COUNTS)
def test_predictor_trainer_step_on_card_matches_cpu(counts):
    """One clipped Adam step at full width (H=128, L=4) on the card against
    the CPU: the loss within 1e-4 relative, every clipped gradient within
    1e-4 of its scale; Adam's first step moves a weight by about lr times
    the sign of its gradient, so the weights agree within 1e-6 wherever the
    gradient is clear of 0 (above 1e-3 of its scale)."""
    _need_card()
    from matinvent_tpu_torch.models.batch import CrystalBatch
    from matinvent_tpu_torch.parallel.train_predictor import PredictorTrainer

    strucs = _random_structures(counts, seed=7)
    batch = CrystalBatch.from_lists([s.species for s in strucs], [s.frac_coords for s in strucs],
                                    [s.lattice for s in strucs], max_atoms=32)
    y = torch.tensor(np.random.default_rng(1).normal(size=len(strucs)), dtype=torch.float32)
    results = []
    for dev in ("cpu", "cuda"):
        gnn = PropertyGNN("mp_bandgap", model_dir="", seed=2, device=dev)
        trainer = PredictorTrainer(gnn, lr=1e-3, grad_clip=0.5)
        loss = trainer.step(trainer.optimizer(), batch, y)
        results.append((float(loss),
                        {k: p.grad.cpu() for k, p in gnn.net.named_parameters() if p.grad is not None},
                        {k: v.cpu() for k, v in gnn.net.state_dict().items()}))
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = results
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    assert g_card.keys() == g_cpu.keys()
    for k, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-12)
        assert (g_card[k] - g).abs().max().item() <= 1e-4 * scale, k
        clear = g.abs() > 1e-3 * scale
        assert (p_card[k] - p_cpu[k])[clear].abs().max().item() <= 1e-6, k


# ---------------------------------------- relaxation, phonons, knn edges


@pytest.fixture
def tf32_on():
    """These paths must not depend on a TF32 setting: run them with TF32
    allowed (the pipeline's default), restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def test_relaxer_on_card_matches_cpu(tf32_on):
    """Coords within 1e-4 (circular) and energies within 1e-4 relative:
    every case after 1 step (the descent is unstable on most corpus
    structures: from the second step the card's and the CPU's rounding part
    them), the stable symmetric cells at 200."""
    from pathlib import Path

    from matinvent_tpu_torch.chem.relax import SoftSphereRelaxer
    from matinvent_tpu_torch.chem.structure import read_extxyz

    root = Path(__file__).resolve().parents[1]
    corpus = read_extxyz(str(root / "experiments/data/corpus_r5.extxyz"), limit=16)
    sym = [rocksalt(4.0, 3, 9), rocksalt(5.9, 82, 16), rocksalt(5.0, 55, 53)]
    for structs, steps in ((corpus + sym, 1), (sym, 200)):
        card, e = SoftSphereRelaxer(steps=steps, max_atoms=20, device="cuda")(structs)
        cpu, e_ref = SoftSphereRelaxer(steps=steps, max_atoms=20, device="cpu")(structs)
        np.testing.assert_allclose(e, e_ref, rtol=1e-4, atol=0)
        for a, b in zip(card, cpu):
            assert np.abs((a.frac_coords - b.frac_coords + 0.5) % 1.0 - 0.5).max() < 1e-4
            np.testing.assert_allclose(a.lattice, b.lattice, rtol=0, atol=1e-4)


def test_hessian_and_heat_capacity_on_card_match_cpu(tf32_on):
    """The Hessian of a 64-atom supercell within 1e-4 of its largest entry,
    and C_v / the bulk modulus of LiF and PbS within 1e-3."""
    from matinvent_tpu_torch.chem import phonon

    sc = phonon.supercell(rocksalt(3.8, 11, 17), (2, 4, 4))
    assert sc.num_atoms == 64
    h = phonon.pair_hessian(sc, torch.device("cuda")).cpu().numpy()
    ref = phonon.pair_hessian(sc, torch.device("cpu")).numpy()
    np.testing.assert_allclose(h, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # C_v once the near-zero acoustic modes each side counts above the
    # 1e10 rad/s floor are accounted for; the bulk modulus where both scale
    # searches end alike
    for s in (rocksalt(4.0, 3, 9), rocksalt(5.9, 82, 16)):
        p = phonon_pair(s, True, 160)
        assert p["cv_gap"] <= 1e-3, p
        assert p["bm_gap"] is None or p["bm_gap"] <= 1e-3, p


def test_knn_mask_on_card_matches_cpu(tf32_on):
    from matinvent_tpu_torch.ops.neighbors import min_image_distances, radius_knn_mask

    rng = np.random.default_rng(0)
    B, A = 16, 20
    na = rng.integers(1, A + 1, B)
    mask = torch.from_numpy(np.arange(A)[None, :] < na[:, None])
    frac = torch.from_numpy(rng.uniform(size=(B, A, 3)).astype(np.float32))
    lat = torch.from_numpy((np.eye(3)[None] * rng.uniform(3, 8, (B, 1, 1))
                            + rng.normal(size=(B, 3, 3)) * 0.4).astype(np.float32))
    d = min_image_distances(frac.cuda(), lat.cuda()).cpu()
    torch.testing.assert_close(d, min_image_distances(frac, lat), rtol=1e-6, atol=0)
    for cutoff, k in ((6.0, 20), (4.0, 5)):
        card = radius_knn_mask(frac.cuda(), lat.cuda(), mask.cuda(), cutoff, k).cpu()
        assert torch.equal(card, radius_knn_mask(frac, lat, mask, cutoff, k))
