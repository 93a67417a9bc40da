"""Start N local ranks of a function as fresh processes; collect their results.

The port's counterpart of the JAX package's multi-process dry run
(``tools/multiprocess_dryrun.py``), used by the tests and ``chip_smoke.py``::

    from efficientdet_tpu_torch.parallel.launch import spawn
    results = spawn("path/to/file.py:fn", world_size=2, kwargs={"x": tensor},
                    device="cpu", timeout_s=120)   # results[r]: rank r's dict

Each rank is ``python -m efficientdet_tpu_torch.parallel.launch`` with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` (127.0.0.1) and
``MASTER_PORT`` (a free port) in its environment, as ``torchrun`` sets them.
It runs one intra-op thread, makes the mesh (``make_mesh(device=...,
backend=..., timeout_s=...)``), calls ``fn(mesh, **kwargs)`` and writes the
dict it returns with ``torch.save``. ``target`` is ``module:function`` or
``file.py:function`` (a path from the repository's root); ``kwargs`` and
the results hold tensors, numbers, strings, lists, tuples and dicts (they
are read back with ``weights_only=True``).

The timeout is hard: the process group's (a collective waiting on a dead
rank raises) and a wall clock in the parent, which kills every rank's
process group when it runs out. The first rank to fail has its traceback
raised in the parent, and the others are killed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, limit: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-limit:]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def spawn(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None,
          device: Optional[str] = None, backend: Optional[str] = None,
          timeout_s: float = 300.0) -> List[Dict[str, Any]]:
    """Run ``target`` on ``world_size`` fresh ranks; rank r's returned dict is
    ``result[r]``. ``device``: "cpu" or "cuda" (None: the GPU, raising
    without one); ``backend``: None picks NCCL on the GPU, gloo on the CPU.
    Raises RuntimeError with the first failing rank's traceback, or
    TimeoutError when the ranks outlive ``timeout_s``."""
    with tempfile.TemporaryDirectory(prefix="edt_ranks_") as tmp:
        torch.save(kwargs or {}, os.path.join(tmp, "kwargs.pt"))
        port = free_port()
        base = dict(os.environ)
        base["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, base.get("PYTHONPATH")) if p)
        procs, logs = [], []
        try:
            for r in range(world_size):
                renv = dict(base, RANK=str(r), WORLD_SIZE=str(world_size), LOCAL_RANK=str(r),
                            LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port))
                log = os.path.join(tmp, f"rank{r}.log")
                logs.append(log)
                cmd = [sys.executable, "-m", "efficientdet_tpu_torch.parallel.launch",
                       "--target", target, "--dir", tmp, "--timeout", str(timeout_s)]
                if device:
                    cmd += ["--device", device]
                if backend:
                    cmd += ["--backend", backend]
                with open(log, "w") as out:
                    procs.append(subprocess.Popen(cmd, env=renv, cwd=ROOT, stdout=out,
                                                  stderr=subprocess.STDOUT,
                                                  start_new_session=True))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    r = failed[0]
                    _kill(procs)
                    raise RuntimeError(f"rank {r} of {world_size} ({target}) exited with "
                                       f"{codes[r]}:\n{_tail(logs[r])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    _kill(procs)
                    tails = "\n".join(f"--- rank {r}:\n{_tail(p, 2000)}" for r, p in enumerate(logs))
                    raise TimeoutError(f"{world_size} ranks of {target} ran past {timeout_s} s\n{tails}")
                time.sleep(0.05)
        finally:
            _kill(procs)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world_size)]


def _resolve(target: str):
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = where if os.path.isabs(where) else os.path.join(ROOT, where)
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(path))[0] + "_rank", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv=None) -> int:
    from .mesh import make_mesh

    p = argparse.ArgumentParser(prog="efficientdet_tpu_torch.parallel.launch")
    p.add_argument("--target", required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--backend", default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args(argv)
    torch.set_num_threads(1)  # N ranks share the host's cores
    mesh = make_mesh(device=args.device, backend=args.backend, timeout_s=args.timeout)
    try:
        kwargs = torch.load(os.path.join(args.dir, "kwargs.pt"), weights_only=True)
        result = _resolve(args.target)(mesh, **kwargs)
        torch.save(result if result is not None else {},
                   os.path.join(args.dir, f"rank{mesh.rank}.pt"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # without the process group's teardown, which waits on the other ranks
    mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
