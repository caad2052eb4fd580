"""Job-level orchestration over the host's cards.

Counterpart of ``mirror_tpu/tools/launcher.py``, itself the reference's
launcher machinery (tools/pretrain_job_launcher.py:38-147 and
downstream_tasks_evaluator.py:69-263 there): a thread-safe deque of
slots, a thread pool sized slots x virtual_factor, and subprocess jobs with
their slot pinned into the child's environment. A numeric slot pins that
card with ``CUDA_VISIBLE_DEVICES``, as the reference does
(pretrain_job_launcher.py:86), in place of the JAX package's ``TPU_*``
masks; the ``cpu`` slot sets ``MIRROR_PLATFORM=cpu``, which every port
entry point takes as the default of its ``--device``
(``utils/platform.py``). With one card, jobs run one after another through
its one slot.
"""

import logging
import os
import subprocess
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

_logger = logging.getLogger("launcher")


class GPUResourceManager:
    """Thread-safe pool of slots (the reference's name and semantics,
    pretrain_job_launcher.py:38-80)."""

    def __init__(self, slots: Sequence[str], virtual_factor: int = 1) -> None:
        self._slots = deque(list(slots) * max(virtual_factor, 1))
        self._cond = threading.Condition()
        self.total = len(self._slots)

    def acquire(self) -> str:
        with self._cond:
            while not self._slots:
                self._cond.wait()
            slot = self._slots.popleft()
            _logger.info("acquired slot %s (%d free)", slot, len(self._slots))
            return slot

    def release(self, slot: str) -> None:
        with self._cond:
            self._slots.append(slot)
            _logger.info("released slot %s (%d free)", slot, len(self._slots))
            self._cond.notify()


def default_slot_env(slot: str) -> dict:
    """A child's environment for ``slot``: ``CUDA_VISIBLE_DEVICES=<slot>``
    for a numeric slot, so parallel fold jobs on a host of several cards do
    not share one; ``MIRROR_PLATFORM=cpu`` for the ``cpu`` slot."""
    if slot == "cpu":
        return {"MIRROR_PLATFORM": "cpu"}
    return {"CUDA_VISIBLE_DEVICES": str(slot)}


def run_distributed(
    cmd: List[str],
    num_processes: int,
    coordinator: str = "localhost:12421",
) -> List[int]:
    """torchrun's counterpart (the reference's scripts/run_train_mirror.sh:
    62-72): ``num_processes`` copies of ``cmd`` on this host with the env
    contract of ``parallel/distributed.py`` (``MIRROR_COORDINATOR``,
    ``MIRROR_NUM_PROCESSES``, ``MIRROR_PROCESS_ID``) and ``LOCAL_RANK=i``,
    so that each process takes its own card. Returns the exit codes."""
    procs = []
    for i in range(num_processes):
        env = dict(os.environ)
        env.update(
            MIRROR_COORDINATOR=coordinator,
            MIRROR_NUM_PROCESSES=str(num_processes),
            MIRROR_PROCESS_ID=str(i),
            LOCAL_RANK=str(i),
        )
        _logger.info("distributed process %d/%d: %s", i, num_processes,
                     " ".join(map(str, cmd)))
        procs.append(subprocess.Popen([str(c) for c in cmd], env=env))
    return [p.wait() for p in procs]


def run_jobs(
    commands: List[List[str]],
    slots: Optional[Sequence[str]] = None,
    virtual_factor: int = 1,
) -> List[int]:
    """Run each command on an acquired slot; returns the exit codes in
    order. A failure is logged and does not stop the pool (the reference's
    pretrain_job_launcher.py:141-145). Each child gets its slot pinned into
    its environment by :func:`default_slot_env`."""
    slots = list(slots) if slots else ["0"]
    manager = GPUResourceManager(slots, virtual_factor)
    results: List[int] = [-1] * len(commands)

    def run_one(idx: int, cmd: List[str]) -> None:
        slot = manager.acquire()
        try:
            env = dict(os.environ)
            pinned = default_slot_env(slot)
            env.update(pinned)
            _logger.info("job %d starting on slot %s (%s): %s", idx, slot,
                         " ".join(f"{k}={v}" for k, v in pinned.items()),
                         " ".join(map(str, cmd)))
            proc = subprocess.run([str(c) for c in cmd], env=env)
            results[idx] = proc.returncode
            if proc.returncode != 0:
                _logger.error("job %d failed with code %d", idx, proc.returncode)
        except Exception:  # a job that cannot start is reported, the pool goes on
            _logger.exception("job %d crashed", idx)
            results[idx] = -1
        finally:
            manager.release(slot)

    with ThreadPoolExecutor(max_workers=manager.total) as pool:
        futures = [pool.submit(run_one, i, c) for i, c in enumerate(commands)]
        for f in futures:
            f.result()
    return results
