"""DataParallel, spawn and launch (port of
``paddle_tpu.distributed.parallel``).

The port runs one process per rank.  :func:`spawn` starts ``nprocs``
ranks with the ``spawn`` start method (CUDA cannot be forked); they meet
at a ``FileStore`` in a fresh temporary directory (never a fixed port,
so concurrent worlds never collide), join the process group
(``init_parallel_env``) and run ``func(*args)``.  ``join=True`` waits
under a deadline (``timeout=`` seconds, 3600 by default): when a rank dies or the deadline passes every rank is
killed and the call raises — a world never hangs its caller.  Each
rank's return value comes back pickled (keep it to numpy and plain
Python) in ``SpawnContext.results``.

:func:`launch` (``python -m paddle_tpu_torch.distributed.launch``) runs
a script in this process under the launch environment, as the JAX one
does (one process per host, wired by the caller), or with
``--nproc_per_node N`` starts N ranks of it through the same machinery.
The supervisor flags of the JAX launcher (``--max-restarts``,
``--hang-timeout``, ``--peer-timeout``, ``--storm-*``) belong to the
gang supervisor, not ported yet (ROADMAP queue A, control plane and operations).

:class:`DataParallel` makes its layer's replicas equal (a broadcast
from rank 0) and averages each gradient over the ``data`` axis as it
is accumulated, so a hand-written loop trains as on one device;
``scale_loss`` / ``apply_collective_grads`` are the reference's no-ops.
"""
from __future__ import annotations

import contextlib
import multiprocessing as _mp
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import List, Optional

import torch

from ..framework.errors import ExecutionTimeoutError, InvalidArgumentError
from ..nn.layer import Layer
from . import env as _env
from .mesh import get_mesh

__all__ = ["DataParallel", "spawn", "launch", "shard_batch", "SpawnContext",
           "RESTART_STORM_EXIT_CODE", "GANG_RESTART_EXIT_CODE"]

#: the JAX package's supervisor exit codes (the supervisor itself is not
#: ported yet; the numbers stay reserved)
RESTART_STORM_EXIT_CODE = 77
GANG_RESTART_EXIT_CODE = 76

class DataParallel(Layer):
    """Wrap a Layer for data parallelism over the mesh's ``data`` axis:
    forward = inner forward; every parameter's gradient is averaged over
    the axis after it is accumulated (a post-accumulate hook).  Inside
    :meth:`no_sync` the hooks do nothing."""

    def __init__(self, layers: Layer, strategy=None,
                 comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1,
                 find_unused_parameters: bool = False):
        super().__init__()
        from . import collective as C

        self._layers = layers
        self._group = get_mesh().group("data")
        self._sync = True
        world = get_mesh().group(tuple(get_mesh().axis_names))
        C._broadcast_coalesced(
            [p.data for p in layers.parameters()] + list(layers.buffers()),
            world, src=0)
        if self._group.size > 1:
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._average)

    def _average(self, p):
        if not self._sync or p.grad is None:
            return
        from . import collective as C

        C.all_reduce(p.grad, group=self._group)
        p.grad.div_(self._group.size)

    @contextlib.contextmanager
    def no_sync(self):
        """Accumulate gradients locally; the first backward after the
        scope averages the sums."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


def shard_batch(x, mesh=None, axes=None):
    """This rank's batch as a tensor on the port's device.  In the JAX
    package this assembles the global array from each host's shard; a
    rank of the port holds its own rows (``DistributedBatchSampler``
    ranked by ``process_index``), so the local rows are the batch.
    ``mesh`` / ``axes`` keep the JAX signature."""
    from ..framework.device import default_device
    from ..framework.dtype import numpy_to_tensor

    if isinstance(x, torch.Tensor):
        return x.to(default_device())
    return numpy_to_tensor(x, default_device())


class SpawnContext:
    """The ranks :func:`spawn` started: ``processes``, and after
    :meth:`join` each rank's return value in ``results``."""

    def __init__(self, processes, workdir: str, timeout: float):
        self.processes = processes
        self.results: List = [None] * len(processes)
        self._dir = workdir
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout

    def _error(self, rank: int) -> str:
        path = os.path.join(self._dir, f"error.{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        return ""

    def _error_time(self, rank: int) -> float:
        path = os.path.join(self._dir, f"error.{rank}.txt")
        return os.path.getmtime(path) if os.path.exists(path) else \
            float("inf")

    def _kill_all(self):
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join(timeout=30)

    def join(self) -> bool:
        """Wait for every rank; raise when one fails or the deadline
        passes (every rank is killed first)."""
        try:
            while True:
                codes = [p.exitcode for p in self.processes]
                bad = [(i, c) for i, c in enumerate(codes)
                       if c not in (None, 0)]
                if bad:
                    self._kill_all()
                    # the rank that failed first leads (its peers' errors
                    # are often the consequence)
                    bad.sort(key=lambda b: self._error_time(b[0]))
                    raise RuntimeError(
                        "spawn: every rank was stopped after "
                        + "; ".join(f"rank {r} exited with code {c}"
                                    for r, c in bad) + "\n"
                        + "\n".join(self._error(r) for r, _ in bad))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self._deadline:
                    self._kill_all()
                    raise ExecutionTimeoutError(
                        f"spawn: ranks {[i for i, c in enumerate(codes) if c is None]}"
                        f" still running after the {self._timeout:g} s "
                        f"deadline; every rank was stopped")
                time.sleep(0.05)
            for i in range(len(self.processes)):
                with open(os.path.join(self._dir, f"result.{i}.pkl"),
                          "rb") as f:
                    self.results[i] = pickle.load(f)
        finally:
            self._kill_all()
            shutil.rmtree(self._dir, ignore_errors=True)
        return True


def _rank_main(func, args, rank: int, env: dict, workdir: str):
    """A spawned rank: its launch environment, the process group, then
    ``func(*args)``; the return value (or the traceback) goes to
    ``workdir``."""
    for k, v in env.items():  # None: unset (no TCP rendezvous)
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_RANK_IN_NODE": str(rank)})
    try:
        _env.init_parallel_env()
        out = func(*args)
        with open(os.path.join(workdir, f"result.{rank}.pkl.tmp"),
                  "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(workdir, f"result.{rank}.pkl.tmp"),
                   os.path.join(workdir, f"result.{rank}.pkl"))
        import torch.distributed as dist

        # no rank leaves while a peer still talks to it (a closed peer
        # aborts gloo's threads); then exit without tearing the group down
        if dist.is_initialized():
            dist.barrier()
        code = 0
    except BaseException:
        with open(os.path.join(workdir, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def spawn(func, args=(), nprocs: Optional[int] = None, join: bool = True,
          daemon: bool = False, **options):
    """Start ``nprocs`` ranks running ``func(*args)`` (``func`` must be
    importable by name: a module-level function).  Options: ``backend``
    (``gloo`` / ``nccl``; default as ``init_parallel_env`` picks it) and
    ``timeout`` (the join deadline in seconds, 3600 by default).  Returns the :class:`SpawnContext`, joined
    when ``join``."""
    backend = _env._resolve_backend(options.pop("backend", None))
    timeout = float(options.pop("timeout", None) or 3600)
    if options:
        raise InvalidArgumentError(
            f"spawn: unknown options {sorted(options)}")
    if nprocs in (None, -1):
        nprocs = torch.cuda.device_count() if backend == "nccl" else 1
    nprocs = int(nprocs)
    if nprocs < 1:
        raise InvalidArgumentError(f"spawn: nprocs={nprocs} must be >= 1")
    workdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_spawn_")
    env = {"PADDLE_TRAINERS_NUM": str(nprocs),
           "PADDLE_TPU_GANG_DIR": workdir,
           "PADDLE_TPU_GANG_TRANSPORT": "file",
           "PADDLE_DISTRI_BACKEND": backend,
           "PADDLE_TRAINER_ENDPOINTS": None,
           "COORDINATOR_ADDRESS": None}
    ctx = _mp.get_context("spawn")
    procs = []
    try:
        for rank in range(nprocs):
            p = ctx.Process(target=_rank_main,
                            args=(func, tuple(args), rank, env, workdir),
                            daemon=daemon, name=f"rank{rank}")
            p.start()
            procs.append(p)
    except BaseException:
        for p in procs:
            p.kill()
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    sc = SpawnContext(procs, workdir, timeout)
    if join:
        sc.join()
    return sc


def _run_script(script: str, argv: List[str]):
    import runpy

    sys.argv = [script] + list(argv)
    runpy.run_path(script, run_name="__main__")


_SUPERVISOR_FLAGS = ("--max-restarts", "--hang-timeout", "--peer-timeout",
                     "--storm-window", "--storm-restarts")


def launch(argv=None):
    """``python -m paddle_tpu_torch.distributed.launch [--nproc_per_node
    N] [--backend gloo|nccl] [--timeout SECONDS] script.py [args...]``.
    Without ``--nproc_per_node``: join the group the environment
    describes and run the script here.  With it: start N ranks of the
    script (:func:`spawn`) and wait for them."""
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = ("usage: python -m paddle_tpu_torch.distributed.launch "
             "[--nproc_per_node=N] [--backend=gloo|nccl] "
             "[--timeout=SECONDS] script.py [args...]")
    nproc = None
    backend = None
    timeout = None

    def _value(flag):
        return flag.split("=", 1)[1] if "=" in flag else argv.pop(0)

    while argv and argv[0].startswith("--"):
        flag = argv.pop(0)
        name = flag.split("=", 1)[0]
        try:
            if name in ("--nproc_per_node", "--nprocs"):
                nproc = int(_value(flag))
                if nproc < 1:
                    raise ValueError
            elif name == "--backend":
                backend = _value(flag)
            elif name == "--timeout":
                timeout = float(_value(flag))
            elif name in _SUPERVISOR_FLAGS:
                print(f"{name} belongs to the gang supervisor, which is not "
                      f"ported yet (ROADMAP queue A, control plane and operations)\n"
                      f"{usage}")
                return 2
            else:
                print(f"unknown launch flag {flag}\n{usage}")
                return 2
        except (IndexError, ValueError):
            print(f"{name} needs a valid value\n{usage}")
            return 2
    if not argv:
        print(usage)
        return 1
    script, *rest = argv
    if nproc is None:
        _env.init_parallel_env(backend=backend)
        _run_script(script, rest)
        return 0
    spawn(_run_script, (os.path.abspath(script), rest), nprocs=nproc,
          backend=backend, timeout=timeout)
    return 0
