"""The port stands alone: it imports torch, numpy, scipy and the standard
library only, never JAX, flax, optax, PyYAML, pandas, msgpack or
``matinvent_tpu`` (the card machine has none of the first six), and ``chip_smoke.py`` fails
cleanly where it cannot run."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "matinvent_tpu_torch"
ALLOWED = {"torch", "numpy", "scipy", "matinvent_tpu_torch"} | set(sys.stdlib_module_names)

# a meta-path finder that refuses the modules the card machine lacks; the
# exact top-level name, so matinvent_tpu_torch still imports. Importing one
# raises; a ``find_spec`` probe (torch.func's import of torch._dynamo
# probes for pandas and others without importing them) finds a spec
BLOCKER = textwrap.dedent(
    """
    import importlib.abc, importlib.machinery, sys
    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "pandas", "msgpack", "matinvent_tpu"}

    class Refuse(importlib.abc.Loader):
        def create_module(self, spec):
            raise ImportError(f"blocked import: {spec.name}")

        def exec_module(self, module):
            raise ImportError(f"blocked import: {module.__name__}")

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                return importlib.machinery.ModuleSpec(name, Refuse())
            return None

    sys.meta_path.insert(0, Blocker())
    """
)


def _run(code: str, cwd: Path = ROOT, timeout: int = 240) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run(
        [sys.executable, "-c", BLOCKER + code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_port_imports_and_samples_without_jax_yaml_or_the_jax_package():
    proc = _run(textwrap.dedent(
        """
        import importlib, pkgutil
        import torch
        import matinvent_tpu_torch as pkg
        torch.set_num_threads(1)
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # imports only, runs nothing
        from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenConfig, MatterGenDiffusion
        from matinvent_tpu_torch.models.mattergen.sample import MatterGenSampler
        from matinvent_tpu_torch.models.suite.mattergen import load_config
        assert load_config(chip_smoke.CKPT).hidden_dim == 256
        model = MatterGenDiffusion(
            MatterGenConfig(hidden_dim=16, num_layers=1, time_dim=8, timesteps=3), device="cpu")
        batch = MatterGenSampler(batch_size=8, num_batches=1, size_buckets=2, max_atoms=8).launch(model)
        assert torch.isfinite(batch.lattice).all()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("modules", len(names))
        """
    ))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "modules" in proc.stdout


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


# the MLIP worker scripts also reach the MLIP stack (quacc and ase, no JAX)
# where it is importable
MLIP_DIR = PACKAGE / "rewards" / "calculators" / "mlip"
MLIP_STACK = {"quacc", "ase"}
# the wandb logger imports wandb where it is installed (it raises where not);
# distillation's teacher builder for published GemNet checkpoints imports the
# external mattergen package and hydra (it raises JAX's ImportError where not);
# the networked-run recipe's stages import the download client, the
# mattergen wheel and the DGL ALIGNN stack inside the stages only
OPTIONAL = {PACKAGE / "pipeline" / "logger.py": {"wandb"},
            PACKAGE / "tools" / "distill_mattergen.py": {"hydra", "mattergen"},
            PACKAGE / "tools" / "first_networked_run.py": {"huggingface_hub", "mattergen",
                                                           "alignn", "jarvis"}}


def test_ast_imports_are_torch_numpy_and_stdlib_only():
    # _build/ holds kernel builds made at run time, not package sources
    files = [p for p in sorted(PACKAGE.rglob("*.py")) if "_build" not in p.parts]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    assert {p.name for p in files if p.parent == MLIP_DIR} >= {"calc.py", "phonon.py", "elastic.py"}
    for path in files:
        allowed = ALLOWED | (MLIP_STACK if path.parent == MLIP_DIR else set())
        allowed |= OPTIONAL.get(path, set())
        extra = _imports(path) - allowed
        assert not extra, f"{path.relative_to(ROOT)} imports {sorted(extra)}"


def test_mlip_workers_run_without_jax_and_the_bridge_keeps_the_environment(tmp_path, monkeypatch):
    """Each worker script, run as the bridge runs it (``__main__``, its own
    checkout on the path), imports no JAX and nothing of the JAX package;
    the bridge hands the worker the caller's environment unchanged."""
    from matinvent_tpu_torch.rewards.calculators.mlip import calc

    for script in ("phonon.py", "elastic.py"):
        out = tmp_path / f"{script}.txt"
        proc = _run(textwrap.dedent(
            f"""
            import runpy
            from matinvent_tpu_torch.chem.structure import Structure, save_extxyz
            import numpy as np
            s = Structure.from_parameters([5.0] * 3, [90] * 3, [55], np.zeros((1, 3)))
            xyz = save_extxyz([s], {str(tmp_path / 'in.extxyz')!r})
            sys.argv = [{script!r}, xyz, {str(out)!r}, "1", "--device", "cpu"]
            runpy.run_path({str(MLIP_DIR / script)!r}, run_name="__main__")
            bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
            assert not bad, bad
            """
        ), cwd=tmp_path)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "backend: native" in proc.stderr
        assert np.isfinite(float(out.read_text()))

    seen = {}

    def fake_run(cmd, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(calc.subprocess, "run", fake_run)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    bridge = calc.MLIPBridge(root_dir=str(tmp_path / "b"), task="heat_capacity", device="cpu")
    with pytest.raises(RuntimeError, match="stop"):
        bridge.calc(([], str(tmp_path / "in.extxyz")))
    assert "env" not in seen  # the worker inherits os.environ as it is


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    # this machine has no card: the script must exit non-zero with no result
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


# the modules of the last reward calculators and of data parallelism
LATE_MODULES = [
    "matinvent_tpu_torch.parallel.mesh",
    "matinvent_tpu_torch.rewards.calculators.alignn.graphs",
    "matinvent_tpu_torch.rewards.calculators.alignn.model",
    "matinvent_tpu_torch.rewards.calculators.alignn.load",
    "matinvent_tpu_torch.rewards.calculators.alignn.calc",
    "matinvent_tpu_torch.rewards.calculators.dft.job",
    "matinvent_tpu_torch.rewards.calculators.dft.calc",
]


def test_alignn_dft_and_mesh_import_alone_and_load_weights_only_first(tmp_path):
    """Each module imports with JAX, PyYAML and the JAX package blocked;
    ``alignn/load.py`` reads a checkpoint with ``weights_only=True`` first
    and falls back to ``weights_only=False`` (JAX's behaviour) only for a
    payload that needs it."""
    for name in LATE_MODULES:
        path = PACKAGE / Path(*name.split(".")[1:]).with_suffix(".py")
        assert _imports(path) <= ALLOWED, name
    proc = _run(textwrap.dedent(
        f"""
        import argparse, importlib, io
        import torch
        for name in {LATE_MODULES!r}:
            importlib.import_module(name)
        from matinvent_tpu_torch.rewards.calculators.alignn import load
        calls = []
        real = torch.load

        def spy(buf, **kw):
            calls.append(kw.get("weights_only"))
            return real(buf, **kw)

        load.torch.load = spy
        plain = io.BytesIO()
        torch.save({{"fc.weight": torch.ones(2, 3)}}, plain)
        assert load._torch_load_cpu(plain.getvalue())["fc.weight"].shape == (2, 3)
        assert calls == [True], calls
        calls.clear()
        odd = io.BytesIO()
        torch.save({{"model": {{"fc.weight": torch.ones(1)}}, "hparams": argparse.Namespace(a=1)}}, odd)
        assert load._torch_load_cpu(odd.getvalue())["hparams"].a == 1
        assert calls == [True, False], calls
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("late modules ok")
        """
    ))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "late modules ok" in proc.stdout


# the tools ported from the JAX package's tools/ in the last slices
TOOL_MODULES = [
    "matinvent_tpu_torch.tools.convert_mattergen_ckpt",
    "matinvent_tpu_torch.tools.distill_mattergen",
    "matinvent_tpu_torch.tools.reward_ceiling",
    "matinvent_tpu_torch.tools.train_predictor",
    "matinvent_tpu_torch.tools.first_networked_run",
]
# modules that import alone too; the weak-scaling harness runs gloo ranks
# on the CPU by design, so it does not ask for a card
IMPORT_ALONE = TOOL_MODULES + ["matinvent_tpu_torch.experiments.weak_scaling"]


def test_tool_modules_import_alone_and_refuse_to_start_without_a_card():
    """Each tool imports with JAX, flax, optax, PyYAML and the JAX package
    blocked, and imports none of them; run as a user runs it without
    ``device=cpu``, each needs the card and says so."""
    for name in IMPORT_ALONE:
        path = PACKAGE / Path(*name.split(".")[1:]).with_suffix(".py")
        assert _imports(path) <= ALLOWED | OPTIONAL.get(path, set()), name
    proc = _run(textwrap.dedent(
        f"""
        import importlib, runpy
        for name in {IMPORT_ALONE!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("imported")
        """
    ))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
    args = {
        "convert_mattergen_ckpt": ["to_torch", "in=experiments/results/pretrained_mattergen_t1000",
                                   "out=never_written"],
        "distill_mattergen": ["teacher=demo", "out=never_written"],
        "reward_ceiling": ["rewards=magnetic_density", "out=never_written/x.json"],
        "train_predictor": ["data=experiments/data/corpus_r5.extxyz",
                            "labels=never_written/labels.txt", "output_dir=never_written"],
        "first_networked_run": ["stages=alex_table"],
    }
    for name in TOOL_MODULES:
        short = name.rsplit(".", 1)[1]
        proc = _run(textwrap.dedent(
            f"""
            import runpy, torch
            torch.cuda.is_available = lambda: False
            sys.argv = [{short!r}] + {args[short]!r}
            runpy.run_module({name!r}, run_name="__main__")
            """
        ))
        assert proc.returncode != 0, name
        assert "CUDA is not available" in proc.stderr, proc.stderr
        assert not (ROOT / "never_written").exists()


# the generation-quality studies and their card check; the diagnosis is
# host only and needs no card
STUDY_MODULES = [
    "matinvent_tpu_torch.experiments.validity_fix_r5",
    "matinvent_tpu_torch.experiments.validity_curve_r5",
    "matinvent_tpu_torch.experiments.type_temperature_ab_r5",
    "matinvent_tpu_torch.experiments.validity_diagnosis_r5",
    "matinvent_tpu_torch.experiments.reward_tail_density_r5",
    "matinvent_tpu_torch.experiments.phonon_ceiling_split_r5",
    "matinvent_tpu_torch.experiments.study_check",
    "matinvent_tpu_torch.tools.check_env",
]
CARD_STUDIES = {
    "validity_fix_r5": ["tag=never", "steps=0", "out=never_written"],
    "validity_curve_r5": ["ckpts=pretrained_geneval_r4", "corpus=experiments/data/reference.extxyz",
                          "out=never_written"],
    "type_temperature_ab_r5": ["taus=1.0", "corpus=experiments/data/reference.extxyz",
                               "out=never_written"],
    "reward_tail_density_r5": ["rewards=magnetic_density", "out=never_written"],
    "phonon_ceiling_split_r5": ["out=never_written"],
    "study_check": ["out=never_written", "results=never_written", "parts=validity_diagnosis"],
}


def test_study_modules_import_alone_and_refuse_to_start_without_a_card():
    for name in STUDY_MODULES:
        path = PACKAGE / Path(*name.split(".")[1:]).with_suffix(".py")
        assert _imports(path) <= ALLOWED, name
    proc = _run(textwrap.dedent(
        f"""
        import importlib
        for name in {STUDY_MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("imported")
        """
    ))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
    for short, args in CARD_STUDIES.items():
        proc = _run(textwrap.dedent(
            f"""
            import runpy, torch
            torch.cuda.is_available = lambda: False
            sys.argv = [{short!r}] + {args!r}
            runpy.run_module("matinvent_tpu_torch.experiments.{short}", run_name="__main__")
            """
        ))
        assert proc.returncode != 0, short
        assert "CUDA is not available" in proc.stderr, proc.stderr
    assert not (ROOT / "never_written").exists()


def test_launch_scripts_run_the_port_only():
    """``matinvent_tpu_torch/scripts/`` starts the port's entry points
    (``python -m matinvent_tpu_torch.<module>``), never the JAX package's
    ``main.py`` / ``gen_eval.py`` or ``matinvent_tpu``."""
    scripts = sorted((PACKAGE / "scripts").glob("*.sh"))
    assert [p.name for p in scripts] == ["gen_eval.sh", "run_rl.sh"]
    for path in scripts:
        text = path.read_text()
        runs = [line.split() for line in text.splitlines()
                if line.lstrip().startswith(("python", "nohup python"))]
        assert runs, path.name
        for words in runs:
            at = words.index("python")
            assert words[at + 1] == "-m" and words[at + 2].startswith("matinvent_tpu_torch."), words
        assert "main.py" not in text and "gen_eval.py" not in text
        assert not any(w.startswith("matinvent_tpu.") or w == "matinvent_tpu"
                       for w in text.replace("/", " ").split())
