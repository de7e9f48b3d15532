"""Port against the JAX package, op by op, on the CPU at f32.

The same numpy inputs go through each JAX function and its counterpart in
``matinvent_tpu_torch``. The JAX fused-edge kernel runs in Pallas interpret
mode, as the JAX package's own tests run it on the CPU; the port's wrapper
runs its plain version, since the tensors lie on the CPU.
"""
from __future__ import annotations

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matinvent_tpu.chem.structure import Structure
from matinvent_tpu.chem.validity import structure_validity as jax_validity
from matinvent_tpu.models.cspnet import sinusoids_embedding as jax_sinusoids
from matinvent_tpu.models.diffcsp import sinusoidal_time_embedding as jax_time_emb
from matinvent_tpu.models.mattergen.corruption import TypeD3PM as JaxD3PM
from matinvent_tpu.models.mattergen.diffusion import (
    MatterGenConfig as JaxConfig,
    MatterGenDiffusion as JaxDiffusion,
)
from matinvent_tpu.ops import fused_edge as jax_fused_edge
from matinvent_tpu.ops.segment import graph_mean as jax_graph_mean
from matinvent_tpu.ops.segment import masked_mean as jax_masked_mean
from matinvent_tpu.ops.wrapped_normal import d_log_p_wrapped_normal as jax_dlogp
from matinvent_tpu_torch.chem.validity import structure_validity
from matinvent_tpu_torch.csrc.build import CSRC, source_digest
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.cspnet import sinusoids_embedding
from matinvent_tpu_torch.models.diffcsp import sinusoidal_time_embedding
from matinvent_tpu_torch.models.mattergen.corruption import TypeD3PM
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
)
from matinvent_tpu_torch.ops.fused_edge import fused_edge_chain
from matinvent_tpu_torch.ops.segment import graph_mean, masked_mean
from matinvent_tpu_torch.ops.wrapped_normal import d_log_p_wrapped_normal
from matinvent_tpu_torch.utils.config import read_flat_yaml

torch.set_num_threads(1)

CKPT = "experiments/results/rl_hhi_rich5/models/final"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the tiled instances' shapes, then the wide route's (h384 at cap 5, a
# 72-atom cap at width 32, width 48, 11 frequencies) at small batch
@pytest.mark.parametrize("B,A,H,nf", [(5, 4, 32, 3), (7, 8, 64, 10), (2, 5, 384, 10),
                                      (2, 72, 32, 10), (3, 8, 48, 10), (3, 8, 64, 11)])
def test_fused_edge_chain_plain_matches_jax_kernel(B, A, H, nf):
    rng = np.random.default_rng(B + A)
    ti = rng.normal(size=(B, A, H)).astype(np.float32)
    tj = rng.normal(size=(B, A, H)).astype(np.float32)
    fr = rng.uniform(size=(B, A, 3)).astype(np.float32)
    na = rng.integers(1, A + 1, (B,))
    mask = np.arange(A)[None, :] < na[:, None]
    ui = (mask / na[:, None]).astype(np.float32)[..., None]
    uj = mask.astype(np.float32)[..., None]
    wd = (rng.normal(size=(6 * nf, H)) * 0.1).astype(np.float32)
    w1 = (rng.normal(size=(H, H)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    args = (ti, tj, fr, ui, uj, wd, w1, b1)
    # 3 crystals per Pallas block divides neither B: the padded-block path
    ref = jax_fused_edge.fused_edge_chain(
        *map(jnp.asarray, args), num_freqs=nf, block_rows=3 * A * A, interpret=True
    )
    before = fused_edge_chain.launches
    out = fused_edge_chain(*map(torch.from_numpy, args), num_freqs=nf)
    assert fused_edge_chain.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-4, rtol=0)
    assert np.all(_np(out)[~mask] == 0.0)  # padded-atom rows exactly zero


def test_sinusoid_embeddings_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(4, 5, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(sinusoids_embedding(torch.from_numpy(x), 10)),
        np.asarray(jax_sinusoids(jnp.asarray(x), 10)), atol=2e-6, rtol=0,
    )
    # phases t * f reach 1000, whose f32 spacing is 6.1e-5: a one-ulp
    # difference of exp(f) between the libraries moves sin/cos that much
    t = np.linspace(1.0, 1000.0, 37).astype(np.float32)
    np.testing.assert_allclose(
        _np(sinusoidal_time_embedding(torch.from_numpy(t), 128)),
        np.asarray(jax_time_emb(jnp.asarray(t), 128)), atol=1e-4, rtol=0,
    )


def test_segment_means_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    mask = np.arange(6)[None, :] < np.array([[1], [4], [6]])
    np.testing.assert_allclose(
        _np(masked_mean(torch.from_numpy(x), torch.from_numpy(mask)[..., None], axis=1)),
        np.asarray(jax_masked_mean(jnp.asarray(x), jnp.asarray(mask)[..., None], axis=1)),
        rtol=1e-6, atol=1e-7,
    )
    for xi in (x, x[..., 0]):
        np.testing.assert_allclose(
            _np(graph_mean(torch.from_numpy(xi), torch.from_numpy(mask))),
            np.asarray(jax_graph_mean(jnp.asarray(xi), jnp.asarray(mask))),
            rtol=1e-6, atol=1e-7,
        )


def test_wrapped_normal_score_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, size=(64,)).astype(np.float32)
    sigma = rng.uniform(0.01, 0.5, size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(d_log_p_wrapped_normal(torch.from_numpy(x), torch.from_numpy(sigma))),
        np.asarray(jax_dlogp(jnp.asarray(x), jnp.asarray(sigma))),
        rtol=2e-5, atol=1e-4,
    )


@pytest.mark.parametrize("kind", ["uniform", "absorbing"])
def test_d3pm_posterior_logits_match_jax(kind):
    N, K, B, A = 10, 7, 4, 5
    jd = JaxD3PM.create(num_classes=K, num_steps=N, kind=kind)
    td = TypeD3PM.create(num_classes=K, num_steps=N, kind=kind)
    assert td.vocab == jd.vocab
    rng = np.random.default_rng(3)
    x_t = rng.integers(0, td.vocab, (B, A)).astype(np.int32)
    logits = rng.normal(size=(B, A, td.vocab)).astype(np.float32)
    t = np.array([1.0, 0.55, 0.2, 0.1], np.float32)  # 0.1 is step index 1
    ref = jd.posterior_logits(jnp.asarray(x_t), jnp.asarray(logits), jnp.asarray(t))
    out = td.posterior_logits(torch.from_numpy(x_t), torch.from_numpy(logits), torch.from_numpy(t))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_step_tables_match_jax(monkeypatch):
    base = dict(hidden_dim=16, num_layers=1, time_dim=128, timesteps=1000)
    jd = JaxDiffusion(JaxConfig(**base))
    td = MatterGenDiffusion(MatterGenConfig(**base), device="cpu")
    grid = _np(td.time_grid())
    # the two linspace implementations round a few grid points differently
    np.testing.assert_allclose(grid, np.asarray(jd.time_grid()), rtol=0, atol=6e-8)
    # with the same grid, every derived table agrees to f32 rounding (the
    # near-1 ratios alpha_i = abar_now / abar_prev amplify a 1-ulp grid step
    # into 1e-3 relative changes of beta_i, so the grid is shared here)
    monkeypatch.setattr(jd, "time_grid", lambda: jnp.asarray(grid))
    ref = jd._step_tables()
    out = td._step_tables()
    assert set(out) == set(ref)
    for k in ref:
        # time_emb: phases up to 1000, see test_sinusoid_embeddings_match_jax
        atol = 1e-4 if k == "time_emb" else 2e-6
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]), rtol=1e-6, atol=atol, err_msg=k)


def test_flat_config_reader_matches_yaml():
    path = f"{CKPT}/config.yaml"
    with open(path) as fh:
        ref = yaml.safe_load(fh)
    assert read_flat_yaml(path) == ref
    cfg = MatterGenConfig.from_dict({**ref, "unknown_key": 1})
    assert cfg.hidden_dim == 256 and cfg.condition_fields == ()


def test_flat_config_reader_rejects_nested(tmp_path):
    for text in ("a:\n  b: 1\n", "stats:\n- [x, 1.0, 2.0]\n", "a: [1, 2]\n", "a: {b: 1}\n"):
        p = tmp_path / "c.yaml"
        p.write_text(text)
        with pytest.raises(ValueError):
            read_flat_yaml(p)
    p.write_text("a: 1.0e-05\nb: 'x y'\nc: null\nd: true\ne: -3\nf: []\n")
    assert read_flat_yaml(p) == yaml.safe_load(p.read_text())


def test_structure_validity_matches_jax_package():
    rng = np.random.default_rng(4)
    lists = []
    for k in range(12):
        n = int(rng.integers(1, 7))
        lat = np.eye(3) * rng.uniform(1.0, 6.0) + rng.normal(size=(3, 3)) * 0.3
        if k == 3:
            lat[2] = lat[0] + lat[1]  # zero volume
        fc = rng.uniform(size=(n, 3))
        if k == 5 and n > 1:
            fc[1] = fc[0] + 1e-3  # a collision
        lists.append((rng.integers(1, 101, n), fc, lat))
    batch = CrystalBatch.from_lists(*zip(*lists), max_atoms=6)
    ref = [jax_validity(Structure(lat, sp, fc)) for sp, fc, lat in lists]
    assert not all(ref) and any(ref)
    assert _np(structure_validity(batch)).tolist() == ref


def test_device_helper():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            MatterGenDiffusion(MatterGenConfig(hidden_dim=16, num_layers=1))


@pytest.mark.parametrize("name", ["fused_edge", "edge_flat"])
def test_build_digest_covers_included_headers(name, tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy, ignore=shutil.ignore_patterns("__pycache__", "*.py"))
    digest = source_digest(name, copy)
    assert digest == source_digest(name, CSRC)  # where csrc lies does not count
    other = copy / ("edge_flat.cu" if name == "fused_edge" else "fused_edge.cu")
    other.write_text(other.read_text() + "\n// a source this one does not include\n")
    assert source_digest(name, copy) == digest
    header = copy / "edge_tiles.cuh"
    assert f'#include "{header.name}"' in (copy / f"{name}.cu").read_text()
    header.write_text(header.read_text() + "\n// an edit of the included header\n")
    edited = source_digest(name, copy)
    assert edited != digest
    # a header included only through another header counts too
    (copy / "deeper.cuh").write_text("#pragma once\n")
    header.write_text('#include "deeper.cuh"\n' + header.read_text())
    nested = source_digest(name, copy)
    (copy / "deeper.cuh").write_text("#pragma once\n// edited\n")
    assert source_digest(name, copy) not in (nested, edited, digest)
