"""The request-job-task serverless abstraction (§3), the port's own copy
of ``repro/core/abstractions.py``.

A *request* is an external trigger (HTTP call). A *job* of matching type
handles it (chat → serving job; fine-tune → preprocess/train/eval jobs).
A *task* is a fine-grained operation within a job (prefill task, decode
task, training shard). JEs decompose requests into jobs and tasks; TEs
execute tasks; the cluster manager owns health and scaling.
"""
from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_ids = itertools.count()


def _mkid(prefix: str) -> str:
    return f"{prefix}-{next(_ids)}"


class RequestType(str, enum.Enum):
    CHAT = "chat"
    BATCH_INFERENCE = "batch_inference"
    FINE_TUNE = "fine_tune"
    EMBEDDING = "embedding"


class JobKind(str, enum.Enum):
    SERVING = "serving"
    PREPROCESS = "preprocess"
    TRAINING = "training"
    EVALUATION = "evaluation"


class TaskKind(str, enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"
    COLOCATED = "colocated"        # single task on a PD-colocated TE
    TRAIN_SHARD = "train_shard"
    EVAL_SHARD = "eval_shard"
    PREPROCESS_SHARD = "preprocess_shard"


class Status(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    REJECTED = "rejected"          # shed by admission control (§11)


@dataclass
class UserRequest:
    rtype: RequestType
    payload: Dict[str, Any]
    req_id: str = field(default_factory=lambda: _mkid("req"))
    arrival: float = field(default_factory=time.monotonic)
    model: str = "default"
    slo_ttft: Optional[float] = None
    slo_tpot: Optional[float] = None


@dataclass
class Task:
    kind: TaskKind
    job_id: str
    payload: Dict[str, Any] = field(default_factory=dict)
    task_id: str = field(default_factory=lambda: _mkid("task"))
    status: Status = Status.PENDING
    te_id: Optional[str] = None
    result: Any = None


@dataclass
class Job:
    kind: JobKind
    request: UserRequest
    job_id: str = field(default_factory=lambda: _mkid("job"))
    tasks: List[Task] = field(default_factory=list)
    status: Status = Status.PENDING
    result: Any = None

    def spawn(self, kind: TaskKind, **payload) -> Task:
        t = Task(kind=kind, job_id=self.job_id, payload=payload)
        self.tasks.append(t)
        return t

    def done(self) -> bool:
        return all(t.status == Status.DONE for t in self.tasks)


def decompose(request: UserRequest) -> List[Job]:
    """Request → jobs, per §3: a chat request triggers one serving job; a
    fine-tune request triggers preprocess + training + evaluation jobs."""
    if request.rtype in (RequestType.CHAT, RequestType.BATCH_INFERENCE,
                         RequestType.EMBEDDING):
        return [Job(JobKind.SERVING, request)]
    if request.rtype == RequestType.FINE_TUNE:
        return [Job(JobKind.PREPROCESS, request),
                Job(JobKind.TRAINING, request),
                Job(JobKind.EVALUATION, request)]
    raise ValueError(request.rtype)
