"""``CSPNet``'s ``ip`` and ``use_dis_emb`` options against the JAX package's,
on the CPU.

``ip=False``: the layers take the raw lattice instead of ``L L^T`` and the
lattice head is not multiplied by the lattice (JAX ``cspnet.py:125-130,
300-304``); ``use_dis_emb=False``: the edge input is the raw ``(x_j - x_i)
mod 1`` (3 lanes) instead of its Fourier embedding, which narrows
``edge_mlp_0`` (JAX ``:93``). Nets synthesized from a seed at the width of
``configs/model/diffcsp.yaml`` (h128, L4), flax params carried across,
f32: every output within 1e-5 of the output's scale (the tolerance of the
port's other CSPNet-vs-JAX tests, there absolute at H16/L1, where the
outputs are O(1)). DiffCSP with ``ip=False`` samples T=8 on JAX's exact
draws within 1e-4 (``tests/test_torch_port_diffcsp.py``'s sampling
tolerance). Checkpoints with ``ip=False`` load through the port's suite;
``use_dis_emb`` is ``CSPNet``'s option only (JAX's ``DiffCSPConfig`` has
no such field and its DiffCSP never sets it), so neither package's suite
loads a DiffCSP checkpoint of such a net.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from matinvent_tpu.models.cspnet import CSPNet as JaxCSPNet
from matinvent_tpu.models.diffcsp import DiffCSPConfig as JaxConfig
from matinvent_tpu.models.diffcsp import DiffCSPDiffusion as JaxDiffusion
from matinvent_tpu.models.suite.diffcsp import DiffCSPSuite as JaxSuite
from matinvent_tpu_torch.models.cspnet import CSPNet
from matinvent_tpu_torch.models.diffcsp import DiffCSPConfig, DiffCSPDiffusion
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import params_from_jax

from test_torch_port_diffcsp import NA, _batch_np, _circ, _jax_sample_draws

torch.set_num_threads(1)

H, L, LAT, K = 128, 4, 256, 100  # configs/model/diffcsp.yaml
TOL = 1e-5
OPTIONS = [(False, True), (True, False), (False, False), (True, True)]


def _inputs(seed=3, B=3, A=6):
    rng = np.random.default_rng(seed)
    num_atoms = np.array([6, 2, 4][:B], np.int32)
    mask = np.arange(A)[None, :] < num_atoms[:, None]
    feats = rng.dirichlet(np.ones(K), (B, A)).astype(np.float32)
    frac = rng.random((B, A, 3)).astype(np.float32)
    lattice = (np.eye(3) * 4.5 + rng.normal(0, 0.4, (B, 3, 3))).astype(np.float32)
    t_emb = rng.normal(size=(B, LAT)).astype(np.float32)
    return t_emb, feats, frac, lattice, num_atoms, mask


@pytest.mark.parametrize("ip,use_dis_emb", OPTIONS)
def test_cspnet_forward_with_each_option_matches_jax(ip, use_dis_emb):
    args = _inputs()
    kw = dict(hidden_dim=H, latent_dim=LAT, num_layers=L, max_atoms=K, ip=ip,
              use_dis_emb=use_dis_emb)
    jnet = JaxCSPNet(**kw)
    params = jnet.init(jax.random.PRNGKey(7), *(jnp.asarray(a) for a in args))
    ref = jnet.apply(params, *(jnp.asarray(a) for a in args))
    net = CSPNet(**kw)
    assert net.csp_layer_0.edge_mlp_0.in_features == 2 * H + 9 + (60 if use_dis_emb else 3)
    sd = params_from_jax(jax.tree.map(np.asarray, params), prefix="")
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = net(*(torch.from_numpy(np.asarray(a)) for a in args))
    for name, a, b in zip(("lattice_out", "coord_out", "type_out"), ours, ref):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1.0)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= TOL * scale, (name, err, scale)


def test_ip_changes_the_output():
    """On the same weights ``ip=False`` moves every head's output (so the
    test above holds the option's own arithmetic, not a shared default)."""
    args = [torch.from_numpy(np.asarray(a)) for a in _inputs()]
    torch.manual_seed(0)
    net = CSPNet(hidden_dim=32, latent_dim=LAT, num_layers=1, max_atoms=K)
    outs = {}
    for ip in (True, False):
        net.ip = ip
        with torch.no_grad():
            outs[ip] = net(*args)
    for a, b in zip(outs[True], outs[False]):
        assert not torch.allclose(a, b)


def _tiny(**cfg):
    base = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, sample_clip=15.0)
    jd = JaxDiffusion(JaxConfig(**{**base, **cfg}))
    params = jd.init_params(jax.random.PRNGKey(0), batch_size=2, max_atoms=5)
    params = jax.tree.map(lambda x: x * 0.02, params)
    model = DiffCSPDiffusion(DiffCSPConfig(**{**base, **cfg}), device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jd, params, model


def test_diffcsp_sampling_with_ip_false_on_jax_draws_matches_jax():
    """T=8 on JAX's exact draws: lattice and coords (circularly) within
    1e-4, types equal."""
    jd, params, model = _tiny(ip=False)
    assert not model.decoder.ip
    key = jax.random.PRNGKey(9)
    ref, _ = jd.sample(params, key, jnp.asarray(NA), max_atoms=5, step_lr=1e-5)
    noise = _jax_sample_draws(key, len(NA), 5, 100, 8)
    out, _ = model.sample(noise, torch.from_numpy(NA), max_atoms=5, step_lr=1e-5)
    np.testing.assert_allclose(out.lattice.numpy(), np.asarray(ref.lattice), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_circ(out.frac_coords.numpy(), ref.frac_coords), 0.0, atol=1e-4)
    np.testing.assert_array_equal(out.atom_types.numpy(), np.asarray(ref.atom_types))


def test_diffcsp_score_net_with_ip_false_matches_jax():
    jd, params, model = _tiny(ip=False)
    types, frac, lat = _batch_np(4)
    from matinvent_tpu.models.diffcsp import NoisedInput as JaxNoised
    from matinvent_tpu.models.diffcsp import sinusoidal_time_embedding as jemb
    from matinvent_tpu_torch.models.diffcsp import NoisedInput

    rng = np.random.default_rng(1)
    B, A = len(NA), 5
    mask = np.arange(A)[None, :] < NA[:, None]
    temb = np.asarray(jemb(jnp.asarray([1, 4, 8]), 16))
    probs = rng.normal(size=(B, A, K)).astype(np.float32)
    ref = jd.apply_net(params, JaxNoised(*(jnp.asarray(a) for a in (temb, probs, frac, lat))),
                       jnp.asarray(NA), jnp.asarray(mask))
    got = model.apply_net(NoisedInput(*(torch.from_numpy(a) for a in (temb, probs, frac, lat))),
                          torch.from_numpy(NA), torch.from_numpy(mask))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r, atol=TOL * max(1.0, np.abs(r).max()), rtol=0)


def _write_checkpoint(path, params, cfg: dict) -> None:
    path.mkdir()
    (path / "params.msgpack").write_bytes(serialization.to_bytes(jax.device_get(params)))
    (path / "config.yaml").write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))


@pytest.mark.parametrize("ip,use_dis_emb", OPTIONS[:3])
def test_checkpoints_with_either_option_load_in_the_port(tmp_path, ip, use_dis_emb):
    """A JAX-written checkpoint directory (``params.msgpack`` and a
    ``config.yaml`` of JAX's fields) of a net with ``ip=False`` loads to the
    same weights and the same score net, the port's ``save_model`` writes
    it back and the JAX suite reads it. A net with ``use_dis_emb=False``
    has a narrower first edge layer than any DiffCSP config describes: the
    port's suite refuses its checkpoint, and the weights JAX's suite
    restores do not have the shapes of the net its config builds."""
    cfg = dict(hidden_dim=32, num_layers=2, time_dim=16, timesteps=8, ip=ip)
    net = JaxCSPNet(hidden_dim=32, latent_dim=16, num_layers=2, max_atoms=K, ip=ip,
                    use_dis_emb=use_dis_emb, smooth=True, pred_type=True)
    B, A = 2, 5
    dummy = (jnp.zeros((B, 16)), jnp.zeros((B, A, K)), jnp.zeros((B, A, 3)),
             jnp.tile(jnp.eye(3), (B, 1, 1)), jnp.full((B,), A, jnp.int32), jnp.ones((B, A), bool))
    params = net.init(jax.random.PRNGKey(3), *dummy)
    _write_checkpoint(tmp_path / "ck", params, cfg)
    if not use_dis_emb:
        with pytest.raises(ValueError):
            DiffCSPSuite(model_path=str(tmp_path / "ck"), device="cpu").load_model()
        jd, jp = JaxSuite(model_path=str(tmp_path / "ck")).load_model()
        built = jd.init_params(jax.random.PRNGKey(0), batch_size=1, max_atoms=A)
        assert ([np.shape(x) for x in jax.tree_util.tree_leaves(jp)]
                != [np.shape(x) for x in jax.tree_util.tree_leaves(built)])
        return
    model = DiffCSPSuite(model_path=str(tmp_path / "ck"), device="cpu").load_model()
    assert model.config.ip == ip
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    for k, v in sd.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v, k)
    args = _inputs(B=2, A=A)
    args = (np.random.default_rng(2).normal(size=(2, 16)).astype(np.float32),) + args[1:]
    ref = net.apply(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = model.decoder(*(torch.from_numpy(np.asarray(a)) for a in args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL * max(1.0, np.abs(r).max()))
    DiffCSPSuite(model_path=str(tmp_path / "ck"), device="cpu").save_model(model, tmp_path / "out")
    jd, jp = JaxSuite(model_path=str(tmp_path / "out")).load_model()
    assert jd.config.ip == ip
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
