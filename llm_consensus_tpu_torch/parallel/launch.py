"""Start a ``torch.distributed`` world of N local processes.

JAX needs no launcher (one controller drives every device); the port runs
one process per rank. :func:`launch` starts them, each joining the world
through a file store in ``workdir`` (no port to pick or collide on), waits
for all of them with a deadline, and returns each rank's result and exit
code. The tests, ``chip_smoke.py`` and the CLI's ``--mesh`` use it;
``torchrun`` is the other way in.

The rank body is named, not pickled: ``target`` is ``"package.module:fn"``
or ``"path/to/file.py:fn"``, imported fresh in each rank, so a rank
imports only what that module imports. ``fn(*args)`` runs after the world
is up; its return value (picklable) comes back as the rank's result. A
rank that raises writes its traceback and exits 1; a rank that exits
non-zero gets its peers killed after a short grace, since they would
only wait in a collective until the world's timeout.

Each rank is ``python -c`` calling :func:`_child` with the work
directory and its rank; callers use :func:`launch`.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from llm_consensus_tpu_torch.parallel.multihost import (
    DistributedConfig,
    initialize_distributed,
)

# The package's parent: a rank must import the package from the same tree.
_ROOT = Path(__file__).resolve().parents[2]
_GRACE_S = 5.0
_CHILD = (
    "import sys; from llm_consensus_tpu_torch.parallel.launch import _child; "
    "_child(sys.argv[1], int(sys.argv[2]))"
)


@dataclass
class RankResult:
    rank: int
    exitcode: int  # the process's exit code; -9 when killed
    result: object = None
    error: str | None = None  # traceback, or why the rank was killed
    log: str = ""  # the tail of the rank's stdout and stderr

    @property
    def ok(self) -> bool:
        return self.exitcode == 0 and self.error is None


def _resolve(target: str):
    where, _, name = target.rpartition(":")
    if not where or not name:
        raise ValueError(f"target must be 'module:fn' or 'file.py:fn', got {target!r}")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def launch(
    target: str,
    nprocs: int,
    args: tuple = (),
    *,
    backend: str,
    workdir: str | os.PathLike,
    deadline_s: float | None,
    timeout_s: float = 120.0,
    rank0_inherits_stdio: bool = False,
) -> list[RankResult]:
    """Run ``target(*args)`` on ``nprocs`` ranks and wait for them.

    ``workdir``: an empty directory for the file store, the spec, each
    rank's result and log. ``deadline_s``: the whole world's wall limit
    (None: none, for an interactive rank 0); ranks still alive then are
    killed. ``timeout_s``: the world's collective timeout
    (:class:`DistributedConfig`). ``rank0_inherits_stdio``: rank 0 reads
    this process's stdin and writes to its stdout and stderr (its log
    stays empty); every other rank's stdin is closed. Returns one :class:`RankResult` per rank, in
    rank order.
    """
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "spec.pkl", "wb") as f:
        pickle.dump(
            dict(target=target, args=args, nprocs=nprocs, backend=backend,
                 timeout_s=timeout_s),
            f,
        )
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), child_env.get("PYTHONPATH", "")) if p
    )
    procs = []
    logs = []
    try:
        for rank in range(nprocs):
            log = open(work / f"rank{rank}.log", "wb")
            logs.append(log)
            inherit = rank == 0 and rank0_inherits_stdio
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, str(work), str(rank)],
                stdin=None if inherit else subprocess.DEVNULL,
                stdout=None if inherit else log,
                stderr=None if inherit else subprocess.STDOUT,
                env={**child_env, "LOCAL_RANK": str(rank)}, cwd=os.getcwd(),
            ))
        killed: dict[int, str] = {}
        end = time.monotonic() + (deadline_s if deadline_s is not None else float("inf"))
        first_fail = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if first_fail is None and any(p.poll() not in (None, 0) for p in procs):
                first_fail = now
            if now > end or (first_fail is not None and now > first_fail + _GRACE_S):
                why = (f"killed at the world's deadline ({deadline_s} s)" if now > end
                       else "killed after a peer rank failed")
                for r, p in enumerate(procs):
                    if p.poll() is None:
                        p.kill()
                        killed[r] = why
                break
            time.sleep(0.05)
        for p in procs:
            p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results = []
    for rank, p in enumerate(procs):
        text = (work / f"rank{rank}.log").read_text(errors="replace")
        out = RankResult(rank=rank, exitcode=p.returncode, log=text[-8000:])
        res = work / f"result{rank}.pkl"
        if res.exists():
            with open(res, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                out.result = value
            else:
                out.error = value
        if rank in killed:
            out.error = killed[rank]
        elif out.error is None and p.returncode != 0:
            out.error = f"exit code {p.returncode}"
        results.append(out)
    return results


def _child(workdir: str, rank: int) -> None:
    """A rank: join the world, run the target, write the result, exit."""
    work = Path(workdir)
    with open(work / "spec.pkl", "rb") as f:
        spec = pickle.load(f)  # written by launch() in the parent
    status, value = "error", None
    try:
        initialize_distributed(
            spec["backend"],
            DistributedConfig(
                init_method=f"file://{work.resolve() / 'store'}",
                world_size=spec["nprocs"], rank=rank, timeout_s=spec["timeout_s"],
            ),
        )
        value = _resolve(spec["target"])(*spec["args"])
        status = "ok"
    except BaseException:  # noqa: BLE001 - reported to the parent, then exit 1
        value = traceback.format_exc()
        print(value, file=sys.stderr, flush=True)
    with open(work / f"result{rank}.tmp", "wb") as f:
        pickle.dump((status, value), f)
    os.replace(work / f"result{rank}.tmp", work / f"result{rank}.pkl")
    sys.stdout.flush()
    sys.stderr.flush()
    # Skip interpreter teardown: a peer that failed may leave collectives
    # of this world pending, and the result is already on disk.
    os._exit(0 if status == "ok" else 1)
