"""The remote queue-job driver of the DFT reward
(``matinvent_tpu/rewards/calculators/dft/job.py``), host code.

``RemoteQueueJob`` connects, uploads the CIF and the config, writes the
submit script ``sub.sh`` (the config's ``scheduler_cmd`` and a call of the
remote ``dft_score`` CLI), submits it (``sbatch`` or ``qsub``), polls the
queue (``squeue`` or ``qstat``) until the job leaves it and reads the
result file, all through a ``Transport``:

* ``SSHTransport``: the OpenSSH CLI (``ssh``/``scp`` with ``BatchMode``),
  retried a bounded number of times;
* ``LocalTransport``: the same protocol against the local machine;
* ``FakeSchedulerTransport``: an in-memory scheduler for tests, which logs
  every command.

Nothing here touches the card.
"""
from __future__ import annotations

import os
import subprocess
import time
from copy import deepcopy
from typing import List

SCHEDULER_CMD = {
    "slurm": {
        "submit": ["sbatch", "INPUT"],
        "state": ["squeue", "--job", "INPUT"],
    },
    "pbs": {
        "submit": ["qsub", "INPUT"],
        "state": ["qstat", "INPUT"],
    },
}


def get_scheduler_cmd(scheduler: str, task: str, args: str, out_str: bool = False):
    cmd = deepcopy(SCHEDULER_CMD[scheduler][task])
    cmd = [args if c == "INPUT" else c for c in cmd]
    return " ".join(cmd) if out_str else cmd


class Transport:
    """exec/put/write primitives against a (possibly remote) machine."""

    def exec(self, cmd: str) -> tuple[str, str]:
        raise NotImplementedError

    def put(self, local_path: str, remote_path: str) -> None:
        raise NotImplementedError

    def write(self, remote_path: str, text: str) -> None:
        raise NotImplementedError


class SSHTransport(Transport):
    """OpenSSH CLI transport with bounded reconnect retries.

    The reference retried connecting forever (job.py:67-79); production
    deployments want bounded retries with backoff, configurable via
    ``max_retries``/``retry_wait``.
    """

    def __init__(
        self,
        hostname: str,
        username: str,
        port: int = 22,
        key_path: str | None = None,
        max_retries: int = 20,
        retry_wait: float = 3.0,
        connect_timeout: int = 15,
    ):
        self.target = f"{username}@{hostname}"
        self.port = port
        self.key_path = key_path
        self.max_retries = max_retries
        self.retry_wait = retry_wait
        self.connect_timeout = connect_timeout

    def _ssh_base(self) -> list[str]:
        cmd = [
            "ssh", "-p", str(self.port), "-o", "BatchMode=yes",
            "-o", f"ConnectTimeout={self.connect_timeout}",
        ]
        if self.key_path:
            cmd += ["-i", self.key_path]
        return cmd + [self.target]

    def _retry(self, fn):
        last = None
        for _ in range(self.max_retries):
            try:
                return fn()
            except subprocess.CalledProcessError as e:
                last = e
                time.sleep(self.retry_wait)
        raise RuntimeError(f"SSH transport failed after {self.max_retries} retries: {last}")

    def exec(self, cmd: str) -> tuple[str, str]:
        def run():
            r = subprocess.run(
                self._ssh_base() + [cmd], capture_output=True, text=True, check=True
            )
            return r.stdout, r.stderr

        return self._retry(run)

    def put(self, local_path: str, remote_path: str) -> None:
        scp = ["scp", "-P", str(self.port), "-o", "BatchMode=yes"]
        if self.key_path:
            scp += ["-i", self.key_path]
        scp += [local_path, f"{self.target}:{remote_path}"]

        def run():
            subprocess.run(scp, capture_output=True, text=True, check=True)

        self._retry(run)

    def write(self, remote_path: str, text: str) -> None:
        def run():
            subprocess.run(
                self._ssh_base() + [f"cat > {remote_path}"],
                input=text, capture_output=True, text=True, check=True,
            )

        self._retry(run)


class LocalTransport(Transport):
    """Runs the same protocol against the local filesystem/shell."""

    def exec(self, cmd: str) -> tuple[str, str]:
        r = subprocess.run(cmd, shell=True, capture_output=True, text=True)
        return r.stdout, r.stderr

    def put(self, local_path: str, remote_path: str) -> None:
        import shutil

        os.makedirs(os.path.dirname(remote_path), exist_ok=True)
        shutil.copy(local_path, remote_path)

    def write(self, remote_path: str, text: str) -> None:
        os.makedirs(os.path.dirname(remote_path), exist_ok=True)
        with open(remote_path, "w") as fh:
            fh.write(text)


class FakeSchedulerTransport(Transport):
    """In-memory scheduler double: jobs 'run' for ``n_polls`` status checks,
    then a result file appears with ``result_value``."""

    def __init__(self, n_polls: int = 2, result_value: float = 1.234,
                 fail_submit: bool = False, empty_result: bool = False):
        self.n_polls = n_polls
        self.result_value = result_value
        self.fail_submit = fail_submit
        self.empty_result = empty_result
        self.files: dict[str, str] = {}
        self.jobs: dict[str, int] = {}
        self._next_id = 1000
        self.log: list[str] = []

    def exec(self, cmd: str) -> tuple[str, str]:
        self.log.append(cmd)
        if cmd.startswith("mkdir"):
            return "", ""
        if "sbatch" in cmd or "qsub" in cmd:
            if self.fail_submit:
                return "", "sbatch: error: invalid partition"
            job_id = str(self._next_id)
            self._next_id += 1
            self.jobs[job_id] = 0
            return f"Submitted batch job {job_id}", ""
        if cmd.startswith("squeue") or cmd.startswith("qstat"):
            job_id = cmd.split()[-1]
            self.jobs[job_id] = self.jobs.get(job_id, 0) + 1
            if self.jobs[job_id] <= self.n_polls:
                return f"  JOBID PARTITION\n  {job_id}  compute", ""
            return "  JOBID PARTITION\n", ""
        if cmd.startswith("cat"):
            if self.empty_result:
                return "", ""
            return f"{self.result_value}\n", ""
        return "", ""

    def put(self, local_path: str, remote_path: str) -> None:
        with open(local_path) as fh:
            self.files[remote_path] = fh.read()

    def write(self, remote_path: str, text: str) -> None:
        self.files[remote_path] = text


class RemoteQueueJob:
    """Submit a scheduler job through a Transport and wait for its result
    file (job.py:31-234 behavior parity)."""

    def __init__(
        self,
        transport: Transport,
        scheduler: str,
        remote_dir: str,
        script_str: str,
        result_path: str | None = None,
        forward_file: List[str] | None = None,
        check_interval: int = 60,
    ) -> None:
        self.transport = transport
        self.scheduler = scheduler
        self.remote_dir = remote_dir
        self.script_str = script_str
        self.result_path = result_path or os.path.join(remote_dir, "DFTScoreResults")
        self.forward_file = forward_file or []
        self.check_interval = check_interval
        self.job_id: str | None = None
        self.job_status: str | None = None

    def create_dir(self) -> None:
        self.transport.exec(f"mkdir -p {self.remote_dir}")

    def file_transfer(self, file_list: List[str]) -> None:
        for file_path in file_list:
            remote_path = os.path.join(self.remote_dir, os.path.basename(file_path))
            self.transport.put(file_path, remote_path)

    def write_submit_job(self) -> str:
        remote_path = os.path.join(self.remote_dir, "sub.sh")
        self.transport.write(remote_path, self.script_str)
        submit_cmd = get_scheduler_cmd(self.scheduler, "submit", remote_path, True)
        stdout, stderr = self.transport.exec(f"cd {self.remote_dir} && {submit_cmd}")
        stdout = stdout.strip()
        try:
            self.job_id = stdout.split()[-1]
        except Exception:
            raise RuntimeError(
                f"Submitting a {self.scheduler} job failed: {stderr.strip()}"
            )
        return self.job_id

    def check_status(self) -> str:
        assert self.job_id is not None
        state_cmd = get_scheduler_cmd(self.scheduler, "state", self.job_id, True)
        stdout, _ = self.transport.exec(state_cmd)
        self.job_status = "RUNNING" if self.job_id in stdout.strip() else "END"
        return self.job_status

    def wait_job_end(self, check_interval: int | None = None) -> None:
        interval = check_interval if check_interval is not None else self.check_interval
        while self.check_status() != "END":
            time.sleep(interval)

    def read_results(self) -> str:
        stdout, _ = self.transport.exec(f"cat {self.result_path}")
        assert stdout != "", "Failed to read results on remote"
        return stdout.strip()

    def submit_wait_read(self) -> str:
        self.create_dir()
        self.file_transfer(self.forward_file)
        self.write_submit_job()
        self.wait_job_end()
        return self.read_results()

    @classmethod
    def from_config(cls, config: dict, transport: Transport | None = None, **kwargs):
        """Build a job from the reference config format (job.py:189-234):
        hostname/username/port/scheduler/remote_dir/scheduler_cmd + task/dir/
        cif/config keys; the submit script calls the remote ``dft_score`` CLI."""
        config = dict(config)
        config.update(kwargs)
        remote_dir = os.path.join(config["remote_dir"], config["dir"])

        forward_file = []
        task_cmd = f"dft_score --task {config['task']} --dir {remote_dir}"
        if "config" in config:
            forward_file.append(config["config"])
            remote_cfg = os.path.join(remote_dir, os.path.basename(config["config"]))
            task_cmd += f" --config {remote_cfg}"
        if "cif" in config:
            forward_file.append(config["cif"])
            remote_cif = os.path.join(remote_dir, os.path.basename(config["cif"]))
            task_cmd += f" --cif {remote_cif}"
        task_cmd += " --machine local --scheduler no"
        script_str = config["scheduler_cmd"] + "\n" + task_cmd

        if transport is None:
            transport = SSHTransport(
                hostname=config["hostname"],
                username=config["username"],
                port=int(config.get("port", 22)),
                key_path=config.get("key_path"),
            )
        return cls(
            transport=transport,
            scheduler=config["scheduler"],
            remote_dir=remote_dir,
            script_str=script_str,
            forward_file=forward_file,
            check_interval=int(config.get("check_interval", 60)),
        )
