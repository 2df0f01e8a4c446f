"""Start the ranks of a data-parallel run.

`spawn(fn, world, args, workdir)` runs fn(*args) on `world` ranks, started by
`torch.multiprocessing.start_processes` with the `spawn` start method (never
a fork, so no rank inherits a CUDA context). The ranks share a process group
on a `file://` store under `workdir`; each puts its result on a queue, and
`spawn` returns the results in rank order. Like any spawn child, a rank
imports the parent's main module under the name `__mp_main__` (its top
level, not its `if __name__ == "__main__":` block), then fn's module. Each
rank sets LOCAL_RANK to its rank, so `multihost.rank_device` gives rank r the
card cuda:r unless fn passes another device.

fn must be a module-level function of an importable module, and its args
and result picklable. A rank that raises, or dies, ends the run: the others
are stopped and `spawn` raises with its traceback, or with the tail of its
output. So does a run that outlives `timeout`.
"""

from __future__ import annotations

import os
import time

import torch.multiprocessing as mp


def _tail(path, n: int = 4000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except (OSError, TypeError):
        return ""


def _rank(r, fn, args, world, init, backend, logs, results):
    """One rank: its output to logs[r] (None: the parent's), the group up,
    fn(*args)'s result on the queue."""
    if logs[r] is not None:
        with open(logs[r], "w") as f:
            os.dup2(f.fileno(), 1)
            os.dup2(f.fileno(), 2)
    os.environ["LOCAL_RANK"] = str(r)
    import torch
    import torch.distributed as dist

    from naqs_tpu_torch.parallel.multihost import initialize_distributed

    if backend == "nccl":
        torch.cuda.set_device(r)
    initialize_distributed(init, world, r, backend=backend)
    try:
        try:
            out = fn(*args)
        except SystemExit as e:   # an argparse error, say: raised so the parent sees it
            raise RuntimeError(f"rank {r} exited with {e.code}") from e
        results.put((r, out))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), workdir: str = ".", backend: str = "gloo",
          timeout=None, show_rank0: bool = False) -> list:
    """fn(*args) on `world` ranks (see the module's docstring); returns their
    results in rank order. backend: "gloo" (the CPU, or ranks that share one
    card) or "nccl". show_rank0: rank 0 writes to this process's stdout and
    stderr; the other ranks' output, and rank 0's otherwise, goes to a log
    file under workdir while they run."""
    os.makedirs(workdir, exist_ok=True)
    base = os.path.join(os.path.abspath(workdir),
                        f"rank_job_{os.getpid()}_{time.monotonic_ns()}")
    logs = [None if (r == 0 and show_rank0) else f"{base}.rank{r}.log" for r in range(world)]
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank, (fn, tuple(args), world, f"file://{base}.store", backend,
                                     logs, results), nprocs=world, join=False,
                             start_method="spawn")
    got = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            while not results.empty():   # drained as they come: a result may outsize the pipe
                r, value = results.get()
                got[r] = value
            try:
                if ctx.join(timeout=0.05):
                    break
            except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
                raise RuntimeError(f"a rank of {world} failed:\n{e}\n" + "\n".join(
                    f"--- rank {r}'s output:\n{_tail(log)}" for r, log in enumerate(logs)
                    if log)) from None
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the ranks outlived {timeout} s; their output:\n" + "\n".join(
                    f"--- rank {r}:\n{_tail(log)}" for r, log in enumerate(logs)))
        while not results.empty():
            r, value = results.get()
            got[r] = value
        return [got[r] for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        for path in [f"{base}.store", *filter(None, logs)]:
            try:
                os.remove(path)
            except OSError:
                pass
