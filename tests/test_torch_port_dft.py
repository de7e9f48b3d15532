"""The port's DFT bridge against the JAX package's, on the CPU.

The JAX suite's ``TestDFTDriver`` cases, each run through both packages on
the same ``FakeSchedulerTransport`` script: the protocol (``transport.log``
and the files it was handed) equal, a failed submit raising, NaN on a
failed job, the fan-out's CIF bytes and values equal. The port's own
``config.yaml`` (read by the port's YAML reader) equals JAX's as
``yaml.safe_load`` reads it.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import yaml

from matinvent_tpu.chem.structure import Structure as JaxStructure
from matinvent_tpu.rewards.calculators.dft import DFT_CONFIG_PATH as JAX_CONFIG
from matinvent_tpu.rewards.calculators.dft import DFTCalc as JaxDFTCalc
from matinvent_tpu.rewards.calculators.dft.calc import dft_run as jax_dft_run
from matinvent_tpu.rewards.calculators.dft.job import (
    FakeSchedulerTransport as JaxFake,
    RemoteQueueJob as JaxJob,
)
from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.rewards.calculators.dft import DFT_CONFIG_PATH, DFTCalc
from matinvent_tpu_torch.rewards.calculators.dft.calc import dft_run
from matinvent_tpu_torch.rewards.calculators.dft.job import (
    FakeSchedulerTransport,
    RemoteQueueJob,
    SSHTransport,
    get_scheduler_cmd,
)
from matinvent_tpu_torch.utils.yaml_io import read_yaml


def _config(tmp_path) -> str:
    cfg = dict(
        machine="remote", scheduler="slurm", hostname="fake", username="u",
        port=22, remote_dir=str(tmp_path / "remote"),
        scheduler_cmd="#!/bin/bash\n#SBATCH -N 1\n", check_interval=0,
    )
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def _job_config(tmp_path, **extra):
    cfg = read_yaml(_config(tmp_path))
    cfg.update(task="band_gap", cif=__file__, **extra)
    return cfg


@pytest.mark.parametrize("scheduler", ["slurm", "pbs"])
def test_job_lifecycle_log_equals_jax(tmp_path, scheduler):
    cfg = _job_config(tmp_path, dir="step00/00", config=_config(tmp_path), scheduler=scheduler)
    ours, ref = FakeSchedulerTransport(n_polls=2, result_value=4.25), JaxFake(n_polls=2,
                                                                             result_value=4.25)
    got = RemoteQueueJob.from_config(dict(cfg), transport=ours).submit_wait_read()
    want = JaxJob.from_config(dict(cfg), transport=ref).submit_wait_read()
    assert got == want and float(got) == 4.25
    assert ours.log == ref.log
    assert ours.files == ref.files
    state = get_scheduler_cmd(scheduler, "state", "1000", True)
    assert sum(c == state for c in ours.log) == 3  # 2 running + 1 end
    assert any(p.endswith("sub.sh") for p in ours.files)


def test_failed_submit_raises_as_jax(tmp_path):
    cfg = _job_config(tmp_path, dir="d")
    for job in (RemoteQueueJob.from_config(dict(cfg), transport=FakeSchedulerTransport(fail_submit=True)),
                JaxJob.from_config(dict(cfg), transport=JaxFake(fail_submit=True))):
        with pytest.raises(RuntimeError, match="Submitting"):
            job.write_submit_job()


def test_dft_run_nan_on_failure_as_jax(tmp_path):
    path = _config(tmp_path)
    assert np.isnan(dft_run("band_gap", "d", __file__, path, FakeSchedulerTransport(empty_result=True)))
    assert np.isnan(jax_dft_run("band_gap", "d", __file__, path, JaxFake(empty_result=True)))
    # an unreadable config and a failed submit are NaN too
    assert np.isnan(dft_run("band_gap", "d", __file__, str(tmp_path / "missing.yaml"),
                            FakeSchedulerTransport()))
    assert np.isnan(dft_run("band_gap", "d", __file__, path, FakeSchedulerTransport(fail_submit=True)))
    assert dft_run("band_gap", "d", __file__, path, FakeSchedulerTransport(result_value=0.5)) == 0.5


def _structures(cls):
    rng = np.random.default_rng(0)
    return [
        cls(np.eye(3) * 4.2 + 0.1 * rng.normal(size=(3, 3)), [11, 17],
            [[0, 0, 0], [0.5, 0.5, 0.5]]),
        cls(np.array([[5.1, 0, 0], [1.1, 4.8, 0], [0.4, 0.3, 5.5]]), [3, 8, 8, 22],
            rng.uniform(0, 1, (4, 3))),
        cls(np.eye(3) * 3.0, [29], np.zeros((1, 3))),
    ]


def test_fan_out_writes_jax_s_cif_bytes_and_values(tmp_path):
    path = _config(tmp_path)
    ours, ref = FakeSchedulerTransport(n_polls=1, result_value=2.0), JaxFake(n_polls=1,
                                                                            result_value=2.0)
    got = DFTCalc(str(tmp_path / "p"), task="band_gap", max_node=3, config_path=path,
                  transport=ours).calc((_structures(Structure), None), "step_0000")
    want = JaxDFTCalc(str(tmp_path / "j"), task="band_gap", max_node=3, config_path=path,
                      transport=ref).calc((_structures(JaxStructure), None), "step_0000")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, [2.0, 2.0, 2.0])
    names = sorted(os.listdir(tmp_path / "p" / "step_0000"))
    assert names == sorted(os.listdir(tmp_path / "j" / "step_0000")) == ["0.cif", "1.cif", "2.cif"]
    for n in names:
        assert (tmp_path / "p" / "step_0000" / n).read_bytes() == \
            (tmp_path / "j" / "step_0000" / n).read_bytes()
    assert (tmp_path / "p" / "step_0000.txt").read_text() == \
        (tmp_path / "j" / "step_0000.txt").read_text()
    # the jobs run in a thread pool: the same commands, in any order
    assert sorted(ours.log) == sorted(ref.log)


def test_config_yaml_equals_jax_s(tmp_path):
    assert read_yaml(DFT_CONFIG_PATH) == yaml.safe_load(open(JAX_CONFIG))
    assert DFTCalc(str(tmp_path / "r"), max_node=1).config_path == os.path.abspath(DFT_CONFIG_PATH)


def test_ssh_transport_commands_are_batch_mode():
    t = SSHTransport(hostname="h", username="u", port=2222, key_path="/k", max_retries=1)
    assert t._ssh_base() == ["ssh", "-p", "2222", "-o", "BatchMode=yes",
                             "-o", "ConnectTimeout=15", "-i", "/k", "u@h"]
