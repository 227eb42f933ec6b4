"""``parallel.modwt_sharded(x, wavelet, level, mesh)``: the forward MODWT
of one signal sharded along time over the configuration's mesh
(``{"signal": R}``), one rank a device, the whole (level + 1, rows, n / R)
output of its shard on every rank every call.

This process is rank 0, on its device (``cuda:0``); it starts ranks
1 … R − 1 (``spawn``), each on its own device, and all join one process
group (NCCL on cards, gloo on the CPU) through ``init_distributed`` and a
file store under ``TMPDIR``, with a finite timeout.  Each rank makes only
its own shard of each pooled signal, from the seed, the rank and the pool
index, on its own device: the whole signal is fixed by the seed and no
rank ever holds it.  Rank 0 sends each call's pool index to the others
over a pipe, so the window holds no collective but the program's own.

A call that raises on any rank makes every later call raise at once (the
others report theirs over the pipes).  Set-up refuses a program whose call
does not fit beside what the window holds (the pool, the kept answer):
the window would run out of device memory.  ``release`` has every other
rank free its pool, check its kept answer and end, within seconds; a rank
that does not answer is killed, so none is left waiting on a collective.

The check: each rank holds its kept answer, in float64, against
``reference/modwt_segment.py`` on its first ``block`` columns (where the
left neighbour's samples enter) and on one block in the middle, over every
row of coefficients.  The samples before the shard are remade from the
seed for the left neighbour's rank, not taken from the program.  Rank 0's
check is the largest error over the ranks (NaN where one gave none).
"""
from __future__ import annotations

import math
import multiprocessing
import shutil
import tempfile
import traceback

import numpy as np
import torch

from .. import core, traffic
from ..reference import filters
from ..reference import modwt_segment as ref

#: seconds the process group's start, or a collective, may wait
GROUP_TIMEOUT_S = 60
#: seconds rank 0 waits for another rank's answer before it ends that rank
ANSWER_TIMEOUT_S = 60


def shard(spec: dict, seed: int, rank: int, item: int, rows: int, n: int,
          device) -> torch.Tensor:
    """Rank ``rank``'s (rows, n) shard of pooled signal ``item``, made on
    ``device`` from its own stream of the seed."""
    mixed = np.random.SeedSequence([seed & ((1 << 63) - 1), rank, item])
    stream = int(mixed.generate_state(1, np.uint64)[0])
    return traffic.signal(spec, rows, n, traffic.generator(stream, device),
                          device)


class Rank:
    """One rank's part of the cell: its shards of the pool, its calls, its
    kept answer and the check of it."""

    def __init__(self, config: dict, workload: dict, seed: int, rank: int,
                 init_method: str, device: torch.device,
                 dtype: torch.dtype):
        from jwave_pro_tpu_torch import parallel

        self.world = math.prod(config["mesh"].values())
        parallel.init_distributed(init_method, self.world, rank,
                                  device_type=device.type,
                                  timeout=GROUP_TIMEOUT_S)
        try:
            self._set_up(config, workload, seed, rank, device, dtype)
        except BaseException:
            # a group left open holds the process's exit for a minute
            self.close()
            raise

    def _set_up(self, config, workload, seed, rank, device, dtype) -> None:
        import jwave_pro_tpu_torch as jt
        from jwave_pro_tpu_torch import parallel
        from torch.distributed.tensor import DTensor, Shard

        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self.rank, self.seed = device, rank, seed
        self.spec, self.level = workload["signal"], config["level"]
        self.wavelet = jt.wavelet(config["wavelet"])
        self.filters = filters.BY_NAME[config["wavelet"]]
        self.block = workload["check"]["block"]
        self.mesh = parallel.make_mesh(config["mesh"], device.type)
        self.modwt_sharded = parallel.modwt_sharded
        lengths = traffic.lengths(workload["lengths"], traffic.rng(seed))
        self.rows = workload["rows"]
        self.n = lengths[0] // self.world
        self.inputs = [shard(self.spec, seed, rank, i, self.rows, self.n,
                             device) for i in range(len(lengths))]
        self.args = [DTensor.from_local(x.to(dtype), self.mesh, [Shard(1)],
                                        run_check=False)
                     for x in self.inputs]
        self.kept = dict.fromkeys(traffic.sample(
            lengths, workload["check"]["sample"], traffic.rng(seed)))
        self._warm_up()

    def _run(self, i: int):
        return self.modwt_sharded(self.args[i], self.wavelet, self.level,
                                  self.mesh)

    def _warm_up(self) -> None:
        """One call, and on a card the memory it needs: the window holds
        the pool and the kept answers while a call runs."""
        if self.device.type != "cuda":
            self._run(0)
            return
        dev = self.device
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = self._run(0).to_local()
        torch.cuda.synchronize(dev)
        answer = out.numel() * out.element_size()
        del out
        need = torch.cuda.max_memory_allocated(dev) - held
        free, _ = torch.cuda.mem_get_info(dev)
        room = free + torch.cuda.memory_reserved(dev) \
            - torch.cuda.memory_allocated(dev)
        want = need + answer * len(self.kept)
        if want > room:
            raise MemoryError(
                f"rank {self.rank}: a call needs {need / core.GIB:.2f} GiB "
                f"beside {len(self.kept)} kept answer(s) of "
                f"{answer / core.GIB:.2f} GiB and the pool's "
                f"{held / core.GIB:.2f} GiB; {room / core.GIB:.2f} GiB free "
                f"on {dev}")

    def call(self, i: int):
        out = self._run(i)
        if i in self.kept:
            self.kept[i] = out
        return out

    def release(self) -> None:
        """Free the program's operands, keeping the sampled inputs."""
        self.args = None
        self.inputs = {i: self.inputs[i] for i in self.kept}

    def _context(self, item: int, halo: int) -> torch.Tensor:
        """The ``halo`` samples before this rank's shard of ``item``,
        remade from the seed for the ranks to its left."""
        pieces, got, k = [], 0, 1
        while got < halo:
            left = shard(self.spec, self.seed, (self.rank - k) % self.world,
                         item, self.rows, self.n, self.device)
            take = min(halo - got, self.n)
            pieces.append(left[..., self.n - take:].clone())
            del left
            got, k = got + take, k + 1
        return torch.cat(pieces[::-1], dim=-1)

    def check(self) -> float:
        """The largest error of the kept answers over the checked blocks,
        relative to the reference's largest magnitude there."""
        h = ref.halo(self.filters, self.level)
        width = min(self.block, self.n)
        blocks = sorted({0, (self.n - width) // 2})
        gap = top = 0.0
        seen = False
        for i, out in self.kept.items():
            if out is None:
                continue
            seen = True
            got = out.to_local()
            context = self._context(i, h)
            for start in blocks:
                want = ref.modwt_segment(self.inputs[i], context,
                                         self.filters, self.level, start,
                                         width)
                part = got[..., start:start + width].double()
                gap = max(gap, float((part - want).abs().max()))
                top = max(top, float(want.abs().max()))
        return gap / top if seen else float("nan")

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def serve(conn, config, workload, seed, rank, init_method, device_type,
          dtype) -> None:
    """Rank ``rank`` > 0: set up, then make each call whose pool index
    rank 0 sends, until ``"finish"``; then check, answer and end."""
    try:
        part = Rank(config, workload, seed, rank, init_method,
                    torch.device(device_type), dtype)
    except Exception:
        conn.send(("failed", f"rank {rank}: {traceback.format_exc()}"))
        return
    conn.send(("ready",))
    failed = False
    try:
        while (msg := conn.recv()) != "finish":
            if failed:
                continue
            try:
                part.call(msg)
            except Exception:
                failed = True
                conn.send(("failed",
                           f"rank {rank}: {traceback.format_exc()}"))
    except EOFError:            # rank 0 is gone
        return
    part.release()
    try:
        err = part.check()
    except Exception:
        err = float("nan")
        conn.send(("failed", f"rank {rank}: {traceback.format_exc()}"))
    conn.send(("checked", err, core.forbidden_modules()))
    part.close()


class Entry:
    CHECK = "modwt_err"

    def __init__(self, config: dict, workload: dict, seed: int,
                 device: torch.device, dtype: torch.dtype):
        world = math.prod(config["mesh"].values())
        lengths = traffic.lengths(workload["lengths"], traffic.rng(seed))
        self.samples = [workload["rows"] * n for n in lengths]
        self.order = traffic.order(len(lengths), workload,
                                   traffic.rng(seed))
        self.failure = ""
        self.errors: dict[int, float] = {}
        self.leaked: list[str] = []
        self.rank = None
        self.tmp = tempfile.mkdtemp(prefix="wavebench-ranks-")
        init_method = f"file://{self.tmp}/store"
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for r in range(1, world):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=serve, daemon=True, args=(
                theirs, config, workload, seed, r, init_method,
                device.type, dtype))
            proc.start()
            theirs.close()
            self.conns.append(mine)
            self.procs.append(proc)
        try:
            self.rank = Rank(config, workload, seed, 0, init_method,
                             device, dtype)
            for r, conn in enumerate(self.conns, 1):
                msg = self._answer(conn, r)
                if msg[0] != "ready":
                    raise RuntimeError(msg[1])
        except BaseException:
            self._end()
            raise

    def _answer(self, conn, r: int):
        """Rank ``r``'s next message, or ("gone", why) where it sent none
        within the timeout or has ended."""
        try:
            if conn.poll(ANSWER_TIMEOUT_S):
                return conn.recv()
        except (EOFError, OSError):
            return ("gone", f"rank {r}: ended without an answer")
        return ("gone", f"rank {r}: no answer in {ANSWER_TIMEOUT_S} s")

    def _poll(self) -> None:
        """Raise if any rank has reported a failed call."""
        for r, conn in enumerate(self.conns, 1):
            try:
                while not self.failure and conn.poll():
                    self.failure = conn.recv()[1]
            except (EOFError, OSError):
                self.failure = self.failure or f"rank {r}: ended"
        if self.failure:
            raise RuntimeError(f"a rank failed: {self.failure}")

    def call(self, i: int):
        self._poll()
        for conn in self.conns:
            conn.send(i)
        try:
            return self.rank.call(i)
        except Exception:
            self.failure = self.failure or f"rank 0: {traceback.format_exc()}"
            raise

    def release(self) -> None:
        """Free rank 0's operands; have every other rank check its answer
        and end."""
        self.rank.release()
        self._finish()
        for r, conn in enumerate(self.conns, 1):
            while (msg := self._answer(conn, r))[0] == "failed":
                self.failure = self.failure or msg[1]
            if msg[0] == "checked":
                self.errors[r] = msg[1]
                self.leaked += msg[2]
        self._end()

    def _finish(self) -> None:
        for conn in self.conns:
            try:
                conn.send("finish")
            except OSError:         # the rank has ended
                pass

    def _end(self) -> None:
        """End the group and the other ranks (killed past the timeout)."""
        self._finish()
        if self.rank is not None and len(self.errors) == len(self.conns):
            self.rank.close()       # every rank closes its side alike
        for proc in self.procs:
            proc.join(ANSWER_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self) -> dict:
        if self.leaked:
            raise RuntimeError(f"a rank loaded {sorted(set(self.leaked))}")
        errs = [self.rank.check()] + [
            self.errors.get(r, float("nan"))
            for r in range(1, len(self.procs) + 1)]
        worst = float("nan") if any(math.isnan(e) for e in errs) \
            else max(errs)
        return {self.CHECK: worst}
