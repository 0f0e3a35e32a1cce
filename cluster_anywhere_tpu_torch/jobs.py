"""Job submission (analogue of the reference's dashboard/modules/job/ —
JobSubmissionClient, JobManager, JobSupervisor).

A submitted job = a shell entrypoint run by a detached JobSupervisor actor,
with logs captured to the session dir and status tracked in the head KV, so
any driver connected to the cluster can submit, poll, stop, and read logs.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

from .core import api as ca
from .core.actor import get_actor, kill

_JOB_NS = "__jobs__"

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


@dataclass
class JobInfo:
    submission_id: str
    status: str
    entrypoint: str
    start_time: float
    end_time: Optional[float] = None
    return_code: Optional[int] = None
    message: str = ""

    @property
    def log_path(self) -> str:
        return f"job-{self.submission_id}.log"


def _kv_put_job(info: JobInfo):
    from .core.worker import global_worker

    global_worker().head_call(
        "kv_put", ns=_JOB_NS, key=info.submission_id, value=json.dumps(info.__dict__).encode()
    )


def _kv_get_job(submission_id: str) -> Optional[JobInfo]:
    from .core.worker import global_worker

    v = global_worker().head_call("kv_get", ns=_JOB_NS, key=submission_id).get("value")
    return JobInfo(**json.loads(v)) if v else None


class JobSupervisor:
    """Detached actor running one job's entrypoint as a subprocess
    (reference job_supervisor.py JobSupervisor)."""

    def __init__(self, submission_id: str, entrypoint: str, env_vars: Dict[str, str], cwd: Optional[str]):
        import subprocess
        import threading

        from .core.worker import global_worker

        self.submission_id = submission_id
        w = global_worker()
        self.log_path = os.path.join(w.session_dir, f"job-{submission_id}.log")
        self.info = JobInfo(
            submission_id=submission_id,
            status=RUNNING,
            entrypoint=entrypoint,
            start_time=time.time(),
        )
        env = dict(os.environ)
        env.update(env_vars or {})
        env["CA_ADDRESS"] = w.session_dir  # the job's driver joins this cluster
        env["CA_JOB_SUBMISSION_ID"] = submission_id
        logf = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            entrypoint,
            shell=True,
            env=env,
            cwd=cwd,
            stdout=logf,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        logf.close()
        _kv_put_job(self.info)
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self):
        rc = self.proc.wait()
        if self.info.status == RUNNING:
            self.info.status = SUCCEEDED if rc == 0 else FAILED
        self.info.return_code = rc
        self.info.end_time = time.time()
        _kv_put_job(self.info)

    def status(self) -> Dict[str, Any]:
        return dict(self.info.__dict__)

    def stop(self) -> str:
        import signal

        if self.proc.poll() is None:
            self.info.status = STOPPED
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
            deadline = time.monotonic() + 3
            while self.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if self.proc.poll() is None:
                try:
                    os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        return self.info.status


class JobSubmissionClient:
    """Submit/inspect jobs on the connected cluster (reference
    dashboard/modules/job/sdk.py JobSubmissionClient — ours talks through the
    actor runtime instead of a REST endpoint)."""

    def __init__(self, address: Optional[str] = None):
        if not ca.is_initialized():
            ca.init(address=address or "auto")

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[Dict[str, Any]] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        submission_id = submission_id or f"job_{uuid.uuid4().hex[:10]}"
        if _kv_get_job(submission_id) is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        env_vars = dict((runtime_env or {}).get("env_vars") or {})
        cwd = (runtime_env or {}).get("working_dir")
        Supervisor = ca.remote(JobSupervisor).options(
            name=f"JOB_SUPERVISOR::{submission_id}",
            lifetime="detached",
            num_cpus=0.01,
            max_concurrency=2,
        )
        h = Supervisor.remote(submission_id, entrypoint, env_vars, cwd)
        ca.get(h.status.remote(), timeout=30)
        return submission_id

    def _supervisor(self, submission_id: str):
        return get_actor(f"JOB_SUPERVISOR::{submission_id}")

    def get_job_status(self, submission_id: str) -> str:
        info = _kv_get_job(submission_id)
        if info is None:
            raise KeyError(f"no job {submission_id!r}")
        return info.status

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = _kv_get_job(submission_id)
        if info is None:
            raise KeyError(f"no job {submission_id!r}")
        return info

    def list_jobs(self) -> List[JobInfo]:
        from .core.worker import global_worker

        w = global_worker()
        keys = w.head_call("kv_keys", ns=_JOB_NS, prefix="")["keys"]
        return [info for k in keys if (info := _kv_get_job(k)) is not None]

    def stop_job(self, submission_id: str) -> bool:
        try:
            sup = self._supervisor(submission_id)
        except Exception:
            return False
        try:
            ca.get(sup.stop.remote(), timeout=15)
            return True
        except Exception:
            return False

    def delete_job(self, submission_id: str) -> bool:
        from .core.worker import global_worker

        info = _kv_get_job(submission_id)
        if info is not None and info.status == RUNNING:
            raise RuntimeError("stop the job before deleting it")
        try:
            kill(self._supervisor(submission_id))
        except Exception:
            pass
        return bool(
            global_worker().head_call("kv_del", ns=_JOB_NS, key=submission_id)["deleted"]
        )

    def get_job_logs(self, submission_id: str) -> str:
        from .core.worker import global_worker

        path = os.path.join(
            global_worker().session_dir, f"job-{submission_id}.log"
        )
        if not os.path.exists(path):
            return ""
        with open(path, "rb") as f:
            return f.read().decode("utf-8", "replace")

    def tail_job_logs(self, submission_id: str, poll_s: float = 0.3) -> Iterator[str]:
        """Yield log chunks until the job reaches a terminal state. Reads only
        the new bytes each poll (no O(n^2) full-file re-reads)."""
        from .core.worker import global_worker

        import codecs

        path = os.path.join(
            global_worker().session_dir, f"job-{submission_id}.log"
        )
        offset = 0
        # incremental decoder: a multibyte character split across two polls
        # must not become U+FFFD
        decoder = codecs.getincrementaldecoder("utf-8")("replace")

        def read_new() -> str:
            nonlocal offset
            if not os.path.exists(path):
                return ""
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read()
            offset += len(data)
            return decoder.decode(data)

        while True:
            chunk = read_new()
            if chunk:
                yield chunk
            status = self.get_job_status(submission_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                chunk = read_new()
                if chunk:
                    yield chunk
                return
            time.sleep(poll_s)

    def wait_until_finish(self, submission_id: str, timeout_s: float = 300.0) -> str:
        deadline = time.monotonic() + timeout_s
        while True:
            status = self.get_job_status(submission_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {submission_id} still {status} after {timeout_s}s"
                )
            time.sleep(0.2)
