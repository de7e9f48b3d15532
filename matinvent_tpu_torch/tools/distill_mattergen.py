"""Distill a torch MatterGen-format teacher into the native score network
(``tools/distill_mattergen.py`` of the JAX package), on the card.

The published MatterGen checkpoints wrap a GemNet-style network that this
framework does not replicate, so their weights cannot be mapped onto the
native score net (``models/suite/mattergen_import.py``). This tool trains
the native net to match a teacher instead:

1. the teacher is any torch module that maps a noised crystal batch at time
   t to the three per-field outputs (cell eps-prediction, sigma-scaled
   wrapped coordinate score, type logits);
2. corpus structures are corrupted across the whole time grid by the
   native corruption (``MatterGenDiffusion.add_noise``);
3. the student learns the teacher's outputs on those noised states (MSE on
   cell and coordinates, KL on the type logits) with optax's
   ``adamw(cosine_decay_schedule(lr, steps, alpha=0.05), weight_decay=1e-5)``;
4. it is checked on held-out noised batches, and by the statistics of two
   samples on the same draws: one scored by the teacher
   (``TeacherScoredDiffusion``), one by the student.

    python -m matinvent_tpu_torch.tools.distill_mattergen teacher=demo \\
        corpus=<data.extxyz> out=<dir> [steps=2000] [batch=64] [hidden=128] \\
        [layers=4] [timesteps=100] [max_atoms=8] [type_vocab=100] [lr=1e-3] \\
        [seed=0] [sample_check_n=32] [builder=file.py:fn] [device=cpu]

Teachers (``teacher=``): ``demo`` builds, saves and reloads a small
GemNet-flavoured torch teacher (``DemoTeacherNet``, the JAX tool's network
and weights for the same seed); a path loads a ``{"state_dict", "config"}``
container: ``architecture: demo_gemnet`` in its config selects the demo
network, a GemNet state dict needs the external ``mattergen`` package (or
``builder=file.py:fn`` / ``module:fn``, called with the config and state
dict), and this framework's own export rebuilds the native net.

Everything runs on the card unless ``device=cpu``: the teacher, the
corruption (draws from a ``torch.Generator`` seeded with ``seed``, not
JAX's keys), the training on the plain net (the edge kernel has no
backward) and both samples. The student's sample runs the edge kernel
(``num_layers x 2 x timesteps`` launches); the teacher-scored one runs no
net. Writes ``<out>/params.msgpack``, ``state_dict.npz`` and
``config.yaml`` (loadable by both packages' ``MatterGenSuite``) and
``<out>/distill_summary.json``, with the JAX tool's keys.
"""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import logging
import os
import sys
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from matinvent_tpu_torch.chem.structure import read_extxyz
from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.batch import CrystalBatch
from matinvent_tpu_torch.models.diffcsp import sinusoidal_time_embedding
from matinvent_tpu_torch.models.mattergen.diffusion import (
    MatterGenConfig,
    MatterGenDiffusion,
    MGNoised,
    NoiseSource,
)
from matinvent_tpu_torch.models.sample import batch_to_structures
from matinvent_tpu_torch.models.suite.mattergen import params_to_jax, save_model
from matinvent_tpu_torch.models.suite.mattergen_import import (
    detect_gemnet,
    mattergen_params_from_state_dict,
    mattergen_state_dict_from_params,
)
from matinvent_tpu_torch.parallel.pretrain import adam_optimizer, cosine_decay_lr
from matinvent_tpu_torch.pipeline.logger import setup_logging

DEFAULT_OUT = "matinvent_tpu_torch/experiments/results/distilled_mattergen"
LR_ALPHA = 0.05  # the cosine decay's floor, a fraction of lr
WEIGHT_DECAY = 1e-5

# ---------------------------------------------------------------- teacher


class _DemoNet(nn.Module):
    """Gaussian RBF expansion of cartesian pair distances, FiLM time
    conditioning and sum/sqrt(n) aggregation over the padded ``[B, A]``
    layout: an architecture disjoint from the student's on purpose."""

    def __init__(self, type_vocab: int, hidden: int, n_blocks: int, n_rbf: int):
        super().__init__()
        self.type_vocab, self.hidden, self.n_rbf = type_vocab, hidden, n_rbf
        self.embed = nn.Embedding(type_vocab, hidden)
        self.film = nn.Sequential(
            nn.Linear(1, hidden), nn.SiLU(), nn.Linear(hidden, 2 * hidden * n_blocks),
        )
        self.edge_mlps = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * hidden + n_rbf, hidden), nn.SiLU(),
                          nn.Linear(hidden, hidden))
            for _ in range(n_blocks)
        )
        self.node_mlps = nn.ModuleList(
            nn.Sequential(nn.Linear(2 * hidden, hidden), nn.SiLU(), nn.Linear(hidden, hidden))
            for _ in range(n_blocks)
        )
        self.pos_head = nn.Linear(hidden, 3, bias=False)
        self.cell_head = nn.Linear(hidden, 9, bias=False)
        self.type_head = nn.Linear(hidden, type_vocab)
        self.register_buffer("centers", torch.linspace(0.0, 8.0, n_rbf))

    def forward(self, types_t, pos_t, cell_t, t, mask):
        # types_t [B,A] long, pos_t [B,A,3], cell_t [B,3,3], t [B], mask [B,A]
        B, A = types_t.shape
        h = self.embed(types_t)
        film = self.film(t[:, None]).reshape(B, -1, 2, self.hidden)
        # minimum-image cartesian pair vectors through the cell
        d = (pos_t[:, None, :, :] - pos_t[:, :, None, :] + 0.5) % 1.0 - 0.5
        cart = torch.einsum("bijk,bkl->bijl", d, cell_t)
        dist = torch.linalg.norm(cart, dim=-1)
        rbf = torch.exp(-((dist[..., None] - self.centers) ** 2) / 0.5)
        emask = (mask[:, :, None] & mask[:, None, :]).float()[..., None]
        inv_sqrt_n = mask.float().sum(-1).clamp(min=1.0).rsqrt()[:, None, None]
        for bi, (emlp, nmlp) in enumerate(zip(self.edge_mlps, self.node_mlps)):
            scale, shift = film[:, bi, 0], film[:, bi, 1]
            hi = h[:, :, None, :].expand(B, A, A, self.hidden)
            hj = h[:, None, :, :].expand(B, A, A, self.hidden)
            e = emlp(torch.cat([hi, hj, rbf], dim=-1)) * emask
            agg = e.sum(dim=2) * inv_sqrt_n
            upd = nmlp(torch.cat([h, agg], dim=-1))
            h = h + upd * (1.0 + scale[:, None, :]) + shift[:, None, :]
        mf = mask.float()[..., None]
        graph = (h * mf).sum(1) / mf.sum(1).clamp(min=1.0)
        # VP-eps cell semantics: symmetric degrees of freedom coupled to the
        # current cell, the field a student of the symmetric SDE can reach
        raw = self.cell_head(graph).reshape(B, 3, 3)
        sym = 0.5 * (raw + raw.transpose(1, 2))
        return {
            "pos": self.pos_head(h),
            "cell": torch.einsum("bij,bjk->bik", sym, cell_t),
            "atomic_numbers": self.type_head(h),
        }


class DemoTeacherNet:
    """The demo teacher: for a seed, the JAX tool's network and weights."""

    @staticmethod
    def build(type_vocab: int, hidden: int = 64, n_blocks: int = 3, n_rbf: int = 16,
              seed: int = 0, device=None) -> nn.Module:
        """Initialized on the CPU from ``torch.manual_seed(seed)`` (the
        caller's RNG state is kept), then moved to ``device``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = _DemoNet(type_vocab, hidden, n_blocks, n_rbf)
        return net.to(resolve_device(device)).eval()


class TorchTeacher:
    """A torch module as the teacher: device tensors in, the per-field
    outputs as float32 device tensors out, with no gradient."""

    def __init__(self, module: nn.Module, type_vocab: int):
        self.module = module
        self.type_vocab = type_vocab

    def __call__(self, types_t, pos_t, cell_t, t, mask) -> dict[str, torch.Tensor]:
        with torch.no_grad():
            out = self.module(types_t.long(), pos_t.float(), cell_t.float(), t.float(),
                              mask.bool())
        return {k: v.float() for k, v in out.items()}


def save_teacher_ckpt(module: nn.Module, path: str, config: dict) -> None:
    """The reference's container ``{"state_dict", "config"}``."""
    torch.save({"state_dict": {k: v.cpu() for k, v in module.state_dict().items()},
                "config": config}, path)


def _builder_demo(config: dict, state_dict, device=None) -> TorchTeacher:
    net = DemoTeacherNet.build(
        type_vocab=int(config["type_vocab"]),
        hidden=int(config.get("hidden", 64)),
        n_blocks=int(config.get("n_blocks", 3)),
        n_rbf=int(config.get("n_rbf", 16)),
        device=device,
    )
    net.load_state_dict(state_dict)
    return TorchTeacher(net, int(config["type_vocab"]))


def _builder_mattergen_wheel(config: dict, state_dict, device=None) -> TorchTeacher:
    """The teacher of a published GemNet-style checkpoint, through the
    external ``mattergen`` package: its diffusion module built from the
    checkpoint's config, the state dict loaded, its (ChemGraph, t)
    interface adapted to the padded-batch teacher's."""
    try:
        from hydra.utils import instantiate as hydra_instantiate
        from mattergen.common.data.chemgraph import ChemGraph
        from mattergen.common.data.collate import collate
    except ImportError as e:
        raise ImportError(
            "loading a published GemNet-style MatterGen checkpoint needs the "
            "external `mattergen` wheel (pip install from "
            "github.com/microsoft/mattergen @5bb2b39, the commit the "
            "reference pins). Alternatively pass builder=<file.py:fn> with "
            f"your own teacher constructor. Underlying error: {e}"
        ) from e

    dev = resolve_device(device)
    diffusion_module = hydra_instantiate(config["lightning_module"]).diffusion_module
    diffusion_module.load_state_dict(
        {k.removeprefix("diffusion_module."): torch.as_tensor(v) for k, v in state_dict.items()},
        strict=False,
    )
    diffusion_module.to(dev).eval()

    def adapter(types_t, pos_t, cell_t, t, mask):
        counts = mask.sum(-1).tolist()
        graphs = [
            ChemGraph(atomic_numbers=types_t[b, :n] + 1, pos=pos_t[b, :n].float(),
                      cell=cell_t[b][None].float(), num_atoms=torch.tensor([n], device=dev))
            for b, n in enumerate(counts)
        ]
        with torch.no_grad():
            out = diffusion_module.model(collate(graphs), t.float())
        B, A = types_t.shape
        pos = torch.zeros((B, A, 3), device=dev)
        typ = torch.zeros((B, A, out.atomic_numbers.shape[-1]), device=dev)
        off = 0
        for b, n in enumerate(counts):
            pos[b, :n] = out.pos[off: off + n]
            typ[b, :n] = out.atomic_numbers[off: off + n]
            off += n
        return {"pos": pos, "cell": out.cell.float(), "atomic_numbers": typ}

    return adapter


class _NativeTeacher:
    """This framework's own score net as the teacher."""

    def __init__(self, diffusion: MatterGenDiffusion):
        self.diff = diffusion

    def __call__(self, types_t, pos_t, cell_t, t, mask) -> dict[str, torch.Tensor]:
        c = self.diff.config
        time_emb = sinusoidal_time_embedding(t * c.timesteps, c.time_dim)
        noised = MGNoised(t, time_emb, types_t.long(), pos_t, cell_t)
        with torch.no_grad():
            out = self.diff.apply_net(noised, mask.sum(-1).int(), mask)
        return {k: v.float() for k, v in out.items()}


def _load_builder(builder: str):
    file_or_mod, fn_name = builder.rsplit(":", 1)
    if file_or_mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_tb", file_or_mod)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(file_or_mod)
    return getattr(mod, fn_name)


def load_teacher(path: str, builder: str | None = None, device=None) -> tuple[Any, dict]:
    """A reference-format container as a teacher on ``device``: (teacher,
    the container's config)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    cfg = ckpt.get("config") or {}
    if builder:
        return _load_builder(builder)(cfg, sd), cfg
    if cfg.get("architecture") == "demo_gemnet":
        return _builder_demo(cfg, sd, device), cfg
    if detect_gemnet(sd):
        return _builder_mattergen_wheel(cfg, sd, device), cfg
    # this framework's own exported container: the native net, its weights
    # through the name map (which refuses GemNet names and wrong shapes)
    diff = MatterGenDiffusion(MatterGenConfig.from_dict(cfg.get("model_cfg") or cfg),
                              device=device)
    sd = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    params = mattergen_params_from_state_dict(sd, params_to_jax(diff.state_dict(), diff))
    diff.load_state_dict(
        {k: torch.from_numpy(v) for k, v in mattergen_state_dict_from_params(params).items()},
        strict=True)
    return _NativeTeacher(diff.eval()), cfg


# ---------------------------------------------------------- teacher sampling


class _TeacherScored(MatterGenDiffusion):
    """The student's sampler (its config, device and schedules; its score
    net shared and never run) taking its predictions from ``teacher``."""

    def __init__(self, diffusion: MatterGenDiffusion, teacher):
        nn.Module.__init__(self)
        self.config, self.device = diffusion.config, diffusion.device
        self.cell_sde, self.coord_ve, self.d3pm = diffusion.cell_sde, diffusion.coord_ve, diffusion.d3pm
        self.decoder = diffusion.decoder
        self.teacher = teacher

    def _guided_preds(self, noised, num_atoms, mask, conditions, guidance, *, fused_edge, dtype):
        return self.teacher(noised.atom_types_t, noised.frac_coords_t, noised.lattice_t,
                            noised.t, mask)


class TeacherScoredDiffusion:
    """The native predictor-corrector sampler scored by the teacher: the
    same steps and the same draws as the student's sample, only the
    predictions differ. No score net runs, so no edge kernel launches."""

    def __init__(self, diffusion: MatterGenDiffusion, teacher):
        self._scored = _TeacherScored(diffusion, teacher)

    def sample(self, noise: NoiseSource | torch.Generator, num_atoms: torch.Tensor,
               max_atoms: int) -> CrystalBatch:
        return self._scored.sample(noise, num_atoms, max_atoms=max_atoms)


# ------------------------------------------------------------- distillation


def structure_batches(corpus_path: str, batch_size: int, max_atoms: int,
                      rng: np.random.Generator) -> list[CrystalBatch]:
    """The corpus's structures of at most ``max_atoms`` atoms, shuffled by
    ``rng`` into full CPU batches, as the JAX tool cuts them."""
    structures = [s for s in read_extxyz(corpus_path) if s.num_atoms <= max_atoms]
    if not structures:
        raise SystemExit(f"no structures <= {max_atoms} atoms in {corpus_path}")
    batches = []
    idx = rng.permutation(len(structures))
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        pick = idx[i: i + batch_size]
        batches.append(CrystalBatch.from_lists(
            [structures[j].species for j in pick],
            [structures[j].frac_coords for j in pick],
            [structures[j].lattice for j in pick],
            max_atoms=max_atoms,
        ))
    return batches


def teacher_targets(teacher, noised: MGNoised, mask: torch.Tensor) -> dict[str, torch.Tensor]:
    return teacher(noised.atom_types_t, noised.frac_coords_t, noised.lattice_t, noised.t, mask)


def distill_loss(diffusion: MatterGenDiffusion, noised: MGNoised, mask, num_atoms, targets):
    """(loss, (l_cell, l_pos, l_type)): the cell MSE over ``[B,3,3]``, the
    masked coordinate MSE over ``3 n`` and the masked type KL(teacher ||
    student) over ``n``, ``n`` the real atoms; the f32 plain net."""
    preds = diffusion.apply_net(noised, num_atoms, mask)
    mf = mask[..., None].float()
    n = torch.clamp(mf.sum(), min=1.0)
    l_cell = torch.mean((preds["cell"] - targets["cell"]) ** 2)
    l_pos = torch.sum(((preds["pos"] - targets["pos"]) ** 2) * mf) / (3.0 * n)
    t_logp = torch.log_softmax(targets["atomic_numbers"], dim=-1)
    s_logp = torch.log_softmax(preds["atomic_numbers"], dim=-1)
    kl = torch.sum(torch.exp(t_logp) * (t_logp - s_logp), dim=-1, keepdim=True)
    l_type = torch.sum(kl * mf) / n
    return l_cell + l_pos + l_type, (l_cell, l_pos, l_type)


def distill_optimizer(diffusion: MatterGenDiffusion, lr: float) -> torch.optim.Optimizer:
    return adam_optimizer(diffusion.parameters(), lr, WEIGHT_DECAY)


def distill_step(diffusion, optimizer, count: int, lr: float, steps: int, noised: MGNoised,
                 batch: CrystalBatch, targets) -> dict[str, torch.Tensor]:
    """One AdamW step (step ``count`` of the cosine decay over ``steps``);
    the loss, its parts and the gradients' global norm before it, as
    device tensors."""
    optimizer.zero_grad(set_to_none=True)
    loss, (l_cell, l_pos, l_type) = distill_loss(
        diffusion, noised, batch.mask, batch.num_atoms, targets)
    loss.backward()
    grads = [p.grad for p in diffusion.parameters() if p.grad is not None]
    grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for group in optimizer.param_groups:
        group["lr"] = cosine_decay_lr(count, lr, max(steps, 1), LR_ALPHA)
    optimizer.step()
    return dict(loss=loss.detach(), cell=l_cell.detach(), pos=l_pos.detach(),
                type=l_type.detach(), grad_norm=grad_norm.detach())


def distill(teacher, diffusion: MatterGenDiffusion, batches: Sequence[CrystalBatch], steps: int,
            lr: float, generator: torch.Generator, log_every: int = 200) -> list[dict]:
    """Train ``diffusion``'s score net in place to match the teacher on
    freshly corrupted batches; the metrics of every logged step."""
    dev = diffusion.device
    batches = [b.to(dev) for b in batches]
    optimizer = distill_optimizer(diffusion, lr)
    history = []
    for step in range(steps):
        batch = batches[step % len(batches)]
        with torch.no_grad():
            noised, _, _ = diffusion.add_noise(batch, None, generator=generator)
        targets = teacher_targets(teacher, noised, batch.mask)
        m = distill_step(diffusion, optimizer, step, lr, steps, noised, batch, targets)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in m.items()}
            history.append(dict(step=step, **m))
            logging.info(f"[distill] step {step}: loss {m['loss']:.5f} (cell {m['cell']:.5f} "
                         f"pos {m['pos']:.5f} type {m['type']:.5f})")
    return history


@torch.no_grad()
def field_mses(diffusion: MatterGenDiffusion, noised: MGNoised, batch: CrystalBatch,
               targets) -> dict[str, float]:
    """Per-field MSE of ``diffusion``'s net against the teacher's targets
    (the masked KL for the types), in float64."""
    preds = {k: v.double() for k, v in diffusion.apply_net(noised, batch.num_atoms,
                                                           batch.mask).items()}
    tg = {k: v.double() for k, v in targets.items()}
    mf = batch.mask[..., None].double()
    n = max(float(mf.sum()), 1.0)
    t_ls = torch.log_softmax(tg["atomic_numbers"], dim=-1)
    s_ls = torch.log_softmax(preds["atomic_numbers"], dim=-1)
    kl = (torch.exp(t_ls) * (t_ls - s_ls)).sum(-1, keepdim=True)
    return {
        "cell": float(torch.mean((preds["cell"] - tg["cell"]) ** 2)),
        "pos": float(torch.sum(((preds["pos"] - tg["pos"]) ** 2) * mf) / (3 * n)),
        "type_kl": float((kl * mf).sum() / n),
    }


def heldout_means(teacher, student, baseline, batches: Sequence[CrystalBatch],
                  generator: torch.Generator | None = None,
                  noised: Sequence[MGNoised] | None = None) -> dict[str, dict[str, float]]:
    """The unrounded means over the held-out batches of the student's and
    the untrained baseline's field MSEs and of the teacher's output power;
    each batch corrupted with ``generator``, or given in ``noised``."""
    dev = student.device
    agg: dict[str, list] = {"student": [], "baseline": [], "teacher_scale": []}
    for i, batch in enumerate(batches):
        batch = batch.to(dev)
        if noised is None:
            with torch.no_grad():
                nz, _, _ = student.add_noise(batch, None, generator=generator)
        else:
            nz = noised[i]
        targets = teacher_targets(teacher, nz, batch.mask)
        agg["student"].append(field_mses(student, nz, batch, targets))
        agg["baseline"].append(field_mses(baseline, nz, batch, targets))
        agg["teacher_scale"].append({
            k: float(torch.mean(targets[k].double() ** 2)) for k in ("cell", "pos")})
    return {name: {k: float(np.mean([d[k] for d in rows])) for k in rows[0]}
            for name, rows in agg.items()}


def heldout_match(teacher, student, baseline, batches: Sequence[CrystalBatch],
                  generator: torch.Generator | None = None,
                  noised: Sequence[MGNoised] | None = None) -> dict:
    """The JAX tool's held-out summary: the means rounded to 6 decimals and
    the student's MSE relative to the teacher's output power."""
    means = heldout_means(teacher, student, baseline, batches, generator, noised)
    student_mse, base, scale = ({k: round(v, 6) for k, v in means[name].items()}
                                for name in ("student", "baseline", "teacher_scale"))
    return {
        "student_mse": student_mse,
        "untrained_baseline_mse": base,
        "teacher_output_power": scale,
        "relative_mse": {
            k: round(student_mse[k] / max(scale.get(k, 1.0), 1e-12), 6) for k in ("cell", "pos")
        },
    }


def sampled_stats(batch: CrystalBatch) -> dict:
    """Count, cell volume mean and spread (finite, in (0, 1e5)) and the
    element histogram of a sampled batch."""
    _, strucs = batch_to_structures(batch)
    vols = np.array([s.volume for s in strucs])
    vols = vols[np.isfinite(vols) & (vols > 0) & (vols < 1e5)]
    types = np.concatenate([s.species for s in strucs]) if strucs else np.array([])
    hist = np.bincount(types.astype(int), minlength=101)[:101]
    hist = hist / max(hist.sum(), 1)
    return {
        "n": len(strucs),
        "vol_mean": float(vols.mean()) if vols.size else None,
        "vol_std": float(vols.std()) if vols.size else None,
        "type_hist": hist,
    }


def student_config(hidden: int, layers: int, timesteps: int, type_vocab: int) -> MatterGenConfig:
    return MatterGenConfig(hidden_dim=hidden, num_layers=layers, time_dim=hidden,
                           timesteps=timesteps, max_atomic_num=type_vocab, sample_clip=30.0)


def main(argv: list[str] | None = None) -> dict:
    """Distills, saves and writes the summary; returns the summary."""
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device)
    setup_logging()
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    teacher_spec = kv.get("teacher", "demo")
    corpus = kv.get("corpus", "experiments/results/dataset.extxyz")
    out_dir = kv.get("out", DEFAULT_OUT)
    steps = int(kv.get("steps", 2000))
    batch_size = int(kv.get("batch", 64))
    hidden = int(kv.get("hidden", 128))
    layers = int(kv.get("layers", 4))
    timesteps = int(kv.get("timesteps", 100))
    max_atoms = int(kv.get("max_atoms", 8))
    type_vocab = int(kv.get("type_vocab", 100))
    lr = float(kv.get("lr", 1e-3))
    seed = int(kv.get("seed", 0))
    sample_check_n = int(kv.get("sample_check_n", 32))
    os.makedirs(out_dir, exist_ok=True)

    if teacher_spec == "demo":
        teacher_path = os.path.join(out_dir, "teacher_last.ckpt")
        net = DemoTeacherNet.build(type_vocab=type_vocab, seed=seed, device=device)
        save_teacher_ckpt(net, teacher_path, {"architecture": "demo_gemnet", "type_vocab": type_vocab})
        logging.info(f"[distill] demo teacher saved -> {teacher_path}")
    else:
        teacher_path = teacher_spec
    teacher, _ = load_teacher(teacher_path, builder=kv.get("builder"), device=device)
    logging.info(f"[distill] teacher loaded from {teacher_path}")

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        student = MatterGenDiffusion(student_config(hidden, layers, timesteps, type_vocab),
                                     device=device)
    baseline = copy.deepcopy(student).eval()

    batches = structure_batches(corpus, batch_size, max_atoms, np.random.default_rng(seed))
    if len(batches) < 2:
        raise SystemExit(
            f"corpus too small for batch_size={batch_size}: only {len(batches)} full "
            f"batch(es) from {corpus}; need >= 2 (one train + one held-out): lower "
            "batch_size or grow the corpus"
        )
    n_held = max(len(batches) // 5, 1)
    train_b, held_b = batches[n_held:], batches[:n_held]
    logging.info(f"[distill] {len(train_b)} train / {len(held_b)} held-out batches")

    distill(teacher, student, train_b, steps, lr,
            torch.Generator(device=device).manual_seed(seed + 2))
    student.eval()
    match = heldout_match(teacher, student, baseline, held_b,
                          torch.Generator(device=device).manual_seed(seed + 3))
    logging.info("[distill] held-out match: " + json.dumps(match))

    # the same sampler on the same draws, scored by the teacher and by the student
    na = torch.full((sample_check_n,), max_atoms // 2, dtype=torch.int32)
    t_final = TeacherScoredDiffusion(student, teacher).sample(
        torch.Generator(device=device).manual_seed(seed + 4), na, max_atoms)
    s_final = student.sample(torch.Generator(device=device).manual_seed(seed + 4), na,
                             max_atoms=max_atoms)
    ts, ss = sampled_stats(t_final), sampled_stats(s_final)
    l1 = float(np.abs(ts.pop("type_hist") - ss.pop("type_hist")).sum())
    stats = {"teacher_sampled": ts, "student_sampled": ss, "type_hist_l1": round(l1, 4)}
    logging.info("[distill] sampled stats: " + json.dumps(stats))

    save_model(student, out_dir)
    summary = dict(
        teacher=teacher_path, steps=steps, batch=batch_size, hidden=hidden, layers=layers,
        timesteps=timesteps, heldout_match=match, sampled_statistics=stats,
    )
    with open(os.path.join(out_dir, "distill_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
        fh.write("\n")
    logging.info(f"[distill] wrote {out_dir}/distill_summary.json")
    return summary


if __name__ == "__main__":
    main()
