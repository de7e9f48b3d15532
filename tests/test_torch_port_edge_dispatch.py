"""Which shapes the edge kernel takes, and the MatterGen sampler's launch
plan, on the CPU.

JAX's Pallas kernel pads its blocks and takes any shape. The port's kernel
(``csrc/fused_edge.cu``) runs its tiled instances at widths 32/64/128/256,
caps up to 64 atoms and up to 10 Fourier frequencies, and its wide route at
every other shape, up to the wide route's shared memory (at 10 frequencies
width 640 in float32 and 1280 in bfloat16; at width 256, 89 frequencies in
float32 and 181 in bfloat16). ``kernel_takes`` states that
rule as a pure function of the shape and ``_check`` enforces it; the
sampler sends every bucket of an fc model through the kernel, so its plan
counts every bucket. On the CPU the wrapper computes its plain version, so
these tests drive the rule, the plan and which calls each bucket's layers
make; the card's launches are checked by ``tests/test_torch_port_cuda.py``
and ``chip_smoke.py`` phase ``edge_shapes``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from matinvent_tpu_torch.models import cspnet
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenConfig, MatterGenDiffusion
from matinvent_tpu_torch.models.mattergen.sample import (
    MatterGenSampler,
    register_num_atoms_distribution,
)
from matinvent_tpu_torch.ops import fused_edge
from matinvent_tpu_torch.ops.fused_edge import kernel_takes

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16

# (hidden, cap, num_freqs, dtype) -> takes: the tiled instances' limits and
# the wide route's just inside and just outside, in both compute dtypes
# (None: bf16 only, which keeps e in half the bytes, so its widest layouts
# reach further); then each dtype's own limits
SHAPES = [
    (h, cap, nf, dt, want if want is not None else dt == BF16)
    for dt in (F32, BF16)
    for h, cap, nf, want in [
        (32, 20, 10, True), (64, 20, 10, True), (128, 20, 10, True), (256, 20, 10, True),
        (16, 20, 10, True), (48, 20, 10, True), (384, 20, 10, True), (512, 20, 10, True),
        (256, 1, 10, True), (256, 64, 10, True), (256, 65, 10, True), (256, 72, 10, True),
        (256, 0, 10, False), (256, 20, 1, True), (256, 20, 0, False), (256, 20, 11, True),
        (640, 20, 10, True), (641, 20, 10, None), (256, 20, 88, True), (256, 20, 89, True),
    ]
] + [(256, 20, 10, torch.float16, False), (256, 20, 10, torch.float64, False)] + [
    (384, 128, 10, F32, True), (384, 128, 10, BF16, True), (256, 20, 90, F32, False),
    (1280, 72, 10, BF16, True), (1281, 20, 10, BF16, False),
    (256, 20, 181, BF16, True), (256, 20, 182, BF16, False),
]


@pytest.mark.parametrize("hidden,cap,nf,dtype,want", SHAPES)
def test_kernel_takes_each_limit(hidden, cap, nf, dtype, want):
    assert kernel_takes(hidden, cap, nf, dtype) is want


def test_the_wide_routes_shared_memory_is_the_one_laid_out_in_the_source():
    """``wide_smem_bytes`` against ``WideLayout`` of ``csrc/fused_edge.cu``
    worked by hand at h384 / 60 lanes (128-row chunks of 64-row weight
    tiles in bf16; 64-row chunks of 32-row tiles in f32, whose e would not
    fit at 128 rows) and h48 / 18 lanes: ring + e + max(emb, the j-sum's
    32 x 136 f32 staging rows) + 4 (Hp + 128 + 3 lanes) + 32 rows + the
    packed stream's table 4 (3 x 256 + 2) (the card's
    ``fused_edge_wide_smem_bytes`` is compared in ``chip_smoke.py``)."""
    table = 4 * (3 * 256 + 2)
    assert fused_edge.wide_smem_bytes(384, 60, BF16) == (
        4 * 64 * 128 * 2 + 128 * 384 * 2 + 32 * 136 * 4 + 4 * (384 + 128 + 180) + 32 * 128 + table)
    assert fused_edge.wide_smem_bytes(384, 60, F32) == (
        4 * 32 * 136 * 4 + 64 * 388 * 4 + 64 * 68 * 4 + 4 * (384 + 128 + 180) + 32 * 64 + table)
    assert fused_edge.wide_smem_bytes(48, 18, F32) == (
        4 * 16 * 136 * 4 + 128 * 132 * 4 + 128 * 36 * 4 + 4 * (128 + 128 + 54) + 32 * 128 + table)
    assert fused_edge.tiled(256, 64, 60) and not fused_edge.tiled(256, 65, 60)
    assert not fused_edge.tiled(384, 20, 60) and not fused_edge.tiled(256, 20, 66)


# (hidden, lanes, dtype) -> (chunk rows, weight-tile rows, ring stages,
# bytes): the first of the layouts that fits, each worked by hand as above
LAYOUTS = [
    (384, 60, BF16, (128, 64, 4, 65536 + 98304 + 17408 + 2768 + 4096 + 3080)),
    (384, 60, F32, (64, 32, 4, 69632 + 99328 + 17408 + 2768 + 2048 + 3080)),
    # f32 h256 (the cap-72 bucket): emb 128 x 68 x 4 over the staging rows
    (256, 60, F32, (128, 16, 4, 34816 + 133120 + 34816 + 2256 + 4096 + 3080)),
    # bf16 h640: 64-row weight tiles no longer fit, 32-row ones do
    (640, 60, BF16, (128, 32, 4, 32768 + 163840 + 17408 + 3792 + 4096 + 3080)),
    # f32 at 88 frequencies: 64-row chunks, three 8-row tiles, emb 64 x 532 x 4
    (256, 528, F32, (64, 8, 3, 13056 + 66560 + 136192 + 7872 + 2048 + 3080)),
    (641, 60, F32, None),
]


@pytest.mark.parametrize("hidden,lanes,dtype,want", LAYOUTS)
def test_the_wide_route_takes_the_first_layout_that_fits(hidden, lanes, dtype, want):
    assert fused_edge.wide_layout(hidden, lanes, dtype) == want
    if want is not None:
        assert fused_edge.wide_smem_bytes(hidden, lanes, dtype) == want[3] <= 227 * 1024


@pytest.mark.parametrize("hidden,cap,nf,dtype", [(641, 20, 10, F32), (1408, 72, 10, BF16),
                                                 (256, 20, 90, F32), (256, 20, 10, torch.float16)])
def test_the_kernels_check_still_raises_on_a_shape_it_cannot_take(hidden, cap, nf, dtype):
    """A direct call of the kernel's wrapper with such a shape raises before
    it looks at the device."""
    B = 2
    t = torch.zeros(B, cap, hidden, dtype=dtype)
    with pytest.raises(ValueError):
        fused_edge._check(t, t, torch.zeros(B, cap, 3), torch.zeros(B, cap, 1),
                          torch.zeros(B, cap, 1), torch.zeros(6 * nf, hidden, dtype=dtype),
                          torch.zeros(hidden, hidden, dtype=dtype), torch.zeros(hidden, dtype=dtype), nf)


def _model(**over) -> MatterGenDiffusion:
    cfg = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=3, beta_max=1.0)
    torch.manual_seed(0)
    return MatterGenDiffusion(MatterGenConfig(**{**cfg, **over}), device="cpu").eval()


def test_plan_counts_only_the_buckets_the_kernel_takes():
    """``max_atoms=72`` in buckets capped at 20 / 40 / 72: the kernel takes
    all three (the 72 bucket on its wide route), so each plans layers x
    (1 + corrector) x T launches; none without ``fused_edge``."""
    model = _model()
    per = 2 * 2 * 3
    assert model.planned_launches() == per and model.planned_launches(fused_edge=False) == 0
    assert all(kernel_takes(32, cap, 10, F32) for cap in (20, 40, 72))
    # the bucket plan of a 72-atom sampler, as MatterGenSampler cuts it
    hist = np.zeros(73)
    hist[[4, 8, 16, 30, 38, 60, 70]] = 1.0
    register_num_atoms_distribution("edge_dispatch_test", hist)
    sampler = MatterGenSampler(batch_size=64, num_batches=1, max_atoms=72, size_buckets=3,
                               num_atoms_distribution="edge_dispatch_test", seed=0)
    _, caps = sampler.bucket_plan(sampler._draw_num_atoms(64))
    assert caps[-1] == 72 and all(c <= 64 for c in caps[:-1])
    assert all(kernel_takes(32, c, 10, F32) for c in caps)


@pytest.mark.parametrize("over,caps,want", [
    (dict(hidden_dim=384), (20, 40), 12),  # no tiled instance: the wide route
    (dict(hidden_dim=48), (8,), 12),
    (dict(sample_dtype="bfloat16"), (20, 64, 68), 12),
    (dict(num_freqs=11), (20,), 12),
    (dict(edge_style="knn"), (20,), 0),  # knn models never take the kernel
])
def test_plan_of_other_shapes(over, caps, want):
    model = _model(**over)
    c = model.config
    assert model.planned_launches() == want
    assert all(kernel_takes(c.hidden_dim, cap, c.num_freqs, F32) for cap in caps)


def _calls_per_bucket(monkeypatch, model, caps, fused=True):
    """Sample one tiny bucket per cap and count, per bucket, the calls of
    the kernel's wrapper (on the CPU its plain version) from the layers."""
    calls = []
    wrapper = cspnet.fused_edge_chain

    def counted(*a, **k):
        calls.append(a[0].shape[1])  # the bucket's cap
        return wrapper(*a, **k)

    monkeypatch.setattr(cspnet, "fused_edge_chain", counted)
    na = [torch.tensor([min(3, cap), cap]) for cap in caps]
    gen = torch.Generator().manual_seed(1)
    out = model.sample_bucketed(gen, na, list(caps), fused_edge=fused)
    return {cap: calls.count(cap) for cap in caps}, out


def test_bucketed_sampling_sends_only_the_buckets_the_kernel_takes_through_it(monkeypatch):
    """At caps 8 and 68 both buckets' layers call the kernel's wrapper
    layers x 2 x T times (the 68 bucket takes the wide route on the card);
    with ``fused_edge=False`` none do, and both buckets' crystals agree
    within 2e-5 (the kernel's plain version computes the same function
    with other rounding)."""
    model = _model()
    counts, fused = _calls_per_bucket(monkeypatch, model, (8, 68))
    assert counts == {8: model.planned_launches(), 68: model.planned_launches()}
    counts_plain, plain = _calls_per_bucket(monkeypatch, model, (8, 68), fused=False)
    assert counts_plain == {8: 0, 68: 0}
    for got, want in zip(fused, plain):
        assert torch.equal(got.num_atoms, want.num_atoms)
        for name in ("frac_coords", "lattice"):
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                       atol=2e-5, rtol=2e-5, err_msg=name)


def test_single_batch_sampling_at_a_width_the_kernel_cannot_take(monkeypatch):
    """``sample`` (one padded batch) at h48, a width of no tiled instance:
    the layers call the kernel's wrapper (the wide route on the card)
    layers x 2 x T times, and the crystals agree with ``fused_edge=False``'s
    within 2e-5."""
    model = _model(hidden_dim=48)
    calls = []
    wrapper = cspnet.fused_edge_chain

    def counted(*a, **k):
        calls.append(1)
        return wrapper(*a, **k)

    monkeypatch.setattr(cspnet, "fused_edge_chain", counted)
    na = torch.tensor([2, 5])
    a = model.sample(torch.Generator().manual_seed(2), na, max_atoms=8)
    b = model.sample(torch.Generator().manual_seed(2), na, max_atoms=8, fused_edge=False)
    assert len(calls) == model.planned_launches()
    for name in ("frac_coords", "lattice"):
        np.testing.assert_allclose(getattr(a, name).numpy(), getattr(b, name).numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=name)
