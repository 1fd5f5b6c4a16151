"""Start and join the ranks of a tensor-parallel run.

:func:`launch` starts one command N times, as ranks 0..N-1 of one
``torch.distributed`` job, and waits for all of them: a rank that fails
ends the others, so nothing waits on a collective that will not come.
The ranks meet through a ``file://`` rendezvous in a fresh temporary
directory, so no TCP port can collide between runs on one machine.
:func:`init` joins the default process group from a rank's environment:
:func:`launch`'s, or ``torchrun``'s (``MASTER_ADDR`` / ``MASTER_PORT``).
Every group gets a timeout of ``TIMEOUT_S``: a rank that dies makes the
others' collectives fail instead of hang.

Usage, from a launcher that wants N ranks of itself::

    if dist.in_rank():
        rank, world = dist.init("gloo")
        ...
    else:
        dist.launch([sys.executable, "-m", "pkg.mod", *argv], world=N)
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as tdist

TIMEOUT_S = 120
_FILE = "REPRO_TORCH_DIST_FILE"


class RankFailed(RuntimeError):
    """A rank exited nonzero or the run outlasted its time limit."""


def in_rank() -> bool:
    """True in a process started as a rank (by :func:`launch` or
    ``torchrun``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def init(backend: str) -> tuple[int, int]:
    """Join the default process group from the environment with
    ``backend`` (``gloo`` or ``nccl``); returns (rank, world size)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if _FILE in os.environ:
        method = f"file://{os.environ[_FILE]}"
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        method = "env://"
    else:
        raise RuntimeError(f"rank {rank}: no rendezvous in the environment "
                           f"(neither {_FILE} nor MASTER_ADDR/MASTER_PORT)")
    tdist.init_process_group(
        backend, init_method=method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return rank, world


def device_for(device: str | None) -> torch.device:
    """A rank's device: ``device`` when given (``cpu``, where the ranks
    share the host's cores: each takes its share of torch's threads, all
    cores or ``OMP_NUM_THREADS``), else ``cuda:{local_rank %
    device_count}``; never the CPU by default."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu":
            world = int(os.environ.get("WORLD_SIZE", "1"))
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the ranks on the CPU")
    dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def check_backend(backend: str, world: int, device: str | None) -> None:
    """Refuse what ``backend`` cannot run, naming the way out: NCCL needs
    CUDA tensors and one device per rank (it refuses two ranks on one
    device).  Nothing is switched here."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown --dist-backend {backend!r} (nccl | gloo)")
    if backend != "nccl":
        return
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"--dist-backend nccl needs CUDA devices, not "
                         f"{device!r}: pass --dist-backend gloo")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < world:
        raise ValueError(
            f"--dist-backend nccl needs one device per rank: {world} ranks, "
            f"{visible} visible device(s); pass --dist-backend gloo to run "
            "the ranks on shared devices")


def launcher_ranks(module: str, argv: list[str], world: int, backend: str,
                   device: str | None):
    """A launcher's ``--tp world``: in the process the user started, run
    ``python -m module argv`` as ``world`` ranks, print rank 0's output
    and return None; in a rank (started so, or by ``torchrun``), join the
    group and return (rank, device).  ``backend`` is the caller's
    explicit choice, checked by :func:`check_backend`."""
    check_backend(backend, world, device)
    if not in_rank():
        print(launch([sys.executable, "-m", module, *argv], world)[0],
              end="", flush=True)
        return None
    rank, size = init(backend)
    if size != world:
        raise ValueError(f"--tp {world} in a group of world size {size}")
    return rank, device_for(device)


def launch(cmd: list[str], world: int, *, env: dict | None = None,
           cwd=None, timeout: float | None = None) -> list[str]:
    """Run ``cmd`` as ranks 0..world-1 and wait for all of them.  Each rank
    gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE`` and the rendezvous file in
    its environment.  When a rank exits nonzero (or ``timeout`` seconds
    pass) the others are killed and :class:`RankFailed` is raised with
    every rank's output.  Returns each rank's standard output."""
    base = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory(prefix="repro_tp_") as tmp:
        procs, logs = [], []
        for r in range(world):
            out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                cmd, cwd=cwd, stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r),
                     "WORLD_SIZE": str(world),
                     _FILE: os.path.join(tmp, "rendezvous")}))
        t0, failed = time.time(), None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if timeout is not None and time.time() - t0 > timeout:
                    failed = f"timed out after {timeout} s"
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if failed is not None:
        dump = "\n".join(f"--- rank {r} stdout\n{o}\n--- rank {r} stderr\n{e}"
                         for r, (o, e) in enumerate(texts))
        raise RankFailed(f"{failed}\n{dump}")
    return [o for o, _ in texts]
