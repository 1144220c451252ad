"""The ranks of the sharded prover, their collectives, and a launcher.

Counterpart of certificate_stark_tpu/parallel/mesh.py (`make_mesh`,
`sharded_prove_core`, :26-46). The JAX package shards over a 1-D device
mesh in one process; the port runs one process a rank, D ranks, one device
a rank, over torch.distributed. Big-domain tensors are block-sharded over
their last axis: rank r of D holds points [r*m/D, (r+1)*m/D) of an m-point
axis (the JAX package's P(None, ..., axis)).

The backend is the caller's choice and never a fallback: `nccl` where each
rank has its own card, `gloo` on the CPU or where ranks share one card
(the ranks then hand their CUDA tensors to gloo through host copies). A
failing NCCL raises. The collectives are all-to-all, all-gather and
broadcast only (no point-to-point: gloo's send/recv take no CUDA tensors),
and no field value is reduced by a SUM all-reduce (int64 sums of canonical
values near 2^63 overflow): partials are gathered and added in the field.

`launch(fn, D, backend)` spawns D ranks on this host (a file store in a
temporary directory), runs fn(mesh, *args) on each and returns the results
by rank.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass
class Mesh:
    """One rank's view of the ranks: its rank, their number D, its device,
    the backend and the process group (None: the default group). `stats`
    counts each collective's calls and the bytes handed to it. `timer`,
    where set, is called with the collective's kind and gives a context
    manager that wraps the call (chip_smoke.py times the collectives with
    one); the collectives themselves never synchronize the device."""
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None
    stats: dict = field(default_factory=dict)
    timer: object = None

    # -- collectives ---------------------------------------------------------
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _count(self, kind, x):
        """Counts a call of collective `kind` on x -> the timer's context
        for it, or a null one."""
        s = self.stats.setdefault(kind, {"calls": 0, "bytes": 0})
        s["calls"] += 1
        s["bytes"] += x.numel() * x.element_size()
        return self.timer(kind) if self.timer else contextlib.nullcontext()

    def all_to_all(self, x, in_splits=None, out_splits=None):
        """torch.distributed all_to_all_single over dim 0 of x: the rows
        in_splits[s] (x.shape[0] / D each where None) go to rank s, and the
        result holds out_splits[s] rows from each rank s, in rank order."""
        x = x.contiguous()
        rows = x.shape[0] if out_splits is None else sum(out_splits)
        with self._count("all_to_all", x):
            src = x.cpu() if self._staged() else x
            out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=src.device)
            dist.all_to_all_single(out, src, out_splits, in_splits,
                                   group=self.group)
            return out.to(self.device)

    def all_gather(self, x):
        """Every rank's x, stacked in rank order -> [D, *x.shape]."""
        x = x.contiguous()
        with self._count("all_gather", x):
            src = x.cpu() if self._staged() else x
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return torch.stack(parts).to(self.device)

    def broadcast(self, x, src: int = 0):
        """Rank src's x on every rank (x: a tensor of the same shape and
        type on each)."""
        x = x.contiguous()
        with self._count("broadcast", x):
            buf = x.cpu() if self._staged() else x.clone()
            root = src if self.group is None else \
                dist.get_global_rank(self.group, src)
            dist.broadcast(buf, root, group=self.group)
            return buf.to(self.device)

    def gather_owned(self, x, owner):
        """x [..., Q] on every rank, owner [Q] the rank whose x holds
        column q -> [..., Q] of the owners' columns, on every rank."""
        g = self.all_gather(x)                                  # [D, ..., Q]
        idx = owner.to(self.device).reshape((1,) * x.dim() + (-1,))
        return g.gather(0, idx.expand((1,) + tuple(x.shape)))[0]

    def reset_stats(self):
        self.stats.clear()


def _device(device, local_rank: int) -> torch.device:
    """None -> cuda:<local rank>, and an error where there is no CUDA
    device; the CPU runs only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the sharded prover runs on cuda:<local "
                "rank> by default; pass device='cpu' (and backend='gloo') "
                "to run it on the CPU")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return device


def check_backend(backend: str, device: torch.device):
    """Refuses what the backend cannot do; never picks another one."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choices {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl moves CUDA tensors only, not {device}: "
                             "name gloo to run the ranks on the CPU")
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("nccl named, but this torch has no CUDA "
                               "device or no NCCL")


def make_mesh(device=None, backend=None, group=None) -> Mesh:
    """This rank's Mesh over an initialised process group (the default
    group, or `group`). `backend`, where given, must be the group's.
    The device is cuda:<local rank> unless the caller names another."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "run the ranks with launch(), or call "
                           "torch.distributed.init_process_group first")
    actual = dist.get_backend(group)
    if backend is not None and backend != actual:
        raise ValueError(f"backend {backend!r} named, but the process group "
                         f"runs {actual!r}")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = _device(device, local)
    check_backend(actual, dev)
    return Mesh(dist.get_rank(group), dist.get_world_size(group), dev,
                actual, group)


def _rank_main(fn, rank, world_size, backend, init_method, device, conn):
    """One spawned rank: receives fn's arguments, joins the process group,
    runs fn(mesh, *args) and sends ("ok", result) or ("error", traceback)
    back."""
    try:
        args = conn.recv()
        # every rank is on this host: bootstrap over the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ["LOCAL_RANK"] = str(rank)
        dev = _device(device, rank)
        check_backend(backend, dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        result = ("ok", fn(make_mesh(dev, backend), *args))
    except BaseException:                    # noqa: BLE001 - sent back
        result = ("error", traceback.format_exc())
    try:
        conn.send(result)
    except Exception:                        # noqa: BLE001 - unpicklable
        conn.send(("error", traceback.format_exc()))
    conn.close()
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, world_size: int, backend: str, device=None, args=(),
           timeout=None) -> list:
    """Spawns world_size ranks on this host, each running fn(mesh, *args)
    (fn a module-level function), and returns their results in rank
    order. `backend` is required: nccl gives rank r the card cuda:r;
    gloo runs on `device` (the CPU, or one card the ranks share). Raises
    with the rank's traceback if a rank fails, after stopping the others;
    every process it starts has ended when it returns."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the ranks run on cuda:<rank> "
                               "by default; pass device='cpu' with gloo")
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"{world_size} ranks need {world_size} CUDA "
                               f"devices; {torch.cuda.device_count()} found")
        check_backend(backend, torch.device("cuda", 0))
    else:
        check_backend(backend, _device(device, 0))
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cstark-mesh-")
    init = "file://" + os.path.join(tmp, "store")
    procs, conns = [], {}
    try:
        for rank in range(world_size):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(fn, rank, world_size, backend, init, device, theirs))
            proc.start()
            theirs.close()
            procs.append(proc)
            conns[ours] = rank
        # the arguments go through the pipes once every rank is starting:
        # in the spawn arguments, a large one would hold each start until
        # that rank had imported its modules
        for conn in conns:
            conn.send(tuple(args))
        results = [None] * world_size
        deadline = None if timeout is None else time.monotonic() + timeout
        while conns:
            left = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            ready = multiprocessing.connection.wait(list(conns), left)
            if not ready:
                raise TimeoutError(f"ranks {sorted(conns.values())} gave no "
                                   f"result within {timeout} s")
            for conn in ready:
                rank = conns.pop(conn)
                try:
                    status, value = conn.recv()
                except EOFError:
                    status, value = "error", (
                        f"exited with code {procs[rank].exitcode} "
                        "before sending a result")
                if status != "ok":
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{value}")
                results[rank] = value
        for proc in procs:
            proc.join(timeout=60)
        return results
    finally:
        # after a failure the other ranks may wait in a collective forever
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)


def sharded_prove_core(prover, trace, t_alpha, t_beta, b_alpha, b_beta):
    """The trace -> composition part of the pipeline on `prover` (a
    parallel.prover.ShardedProver): the whole trace [w, n] and the four
    coefficient tensors in, the composition leaf digests of this rank's
    block [digest_len, bn/D] out."""
    _, lde = prover.phase_trace(trace)
    _, h_lde = prover.phase_composition(lde, t_alpha, t_beta, b_alpha,
                                        b_beta)
    k, d = prover.k, prover.d
    return prover.hasher.hash_columns(
        h_lde.transpose(0, 1).reshape(k * d, h_lde.shape[-1]))
