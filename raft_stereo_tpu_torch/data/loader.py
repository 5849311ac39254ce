"""Host-side batch loader: shuffling, worker-pool decode/augment,
prefetch. The port's copy of the JAX package's `raft_stereo_tpu/data/
loader.py` (the reference's torch DataLoader with num_workers, shuffle and
drop_last), numpy only:

- A thread or process pool runs the numpy decode/augment pipeline and
  assembles fixed-shape NHWC batches; process workers start from a
  forkserver and hand their payloads back through POSIX shared memory.
- Deterministic seeding: item RNG = default_rng((seed, epoch, index)), the
  epoch's order default_rng((seed, epoch)).permutation, so every sample is
  reproducible regardless of worker scheduling, and a seed gives the JAX
  loader's batches.
- A bounded prefetch queue keeps `prefetch` batches ready.
- drop_last: only full batches are emitted.
- Degradation (utils/resilience.py): under sample_policy="quarantine" a
  sample that keeps failing decode is retried, quarantined out of future
  epochs and substituted by a deterministic resample; the run hard-fails
  only past the failure budget.
- `state_dict` / `load_state_dict` carry the stream cursor (epoch, batch
  cursor, quarantine set) through a checkpoint.
"""

from __future__ import annotations

import atexit
from concurrent.futures import BrokenExecutor, ProcessPoolExecutor, ThreadPoolExecutor
import logging
import queue
import threading
import time
from typing import Dict, Iterator, Optional
import weakref

import numpy as np

from raft_stereo_tpu_torch.data.datasets import StereoDataset
from raft_stereo_tpu_torch.utils.resilience import (
    SAMPLE_POLICIES,
    FailureBudgetExceeded,
    SampleQuarantine,
)

logger = logging.getLogger(__name__)

# Process-pool workers: the dataset ships once per worker (initializer), then
# tasks carry only (epoch, index), the worker model of the reference's torch
# DataLoader. Threads share memory but the numpy augment path holds the GIL
# between numpy calls, so processes are the scaling path on many-core hosts.
# Workers import this module and the dataset's, which are numpy only: no
# worker imports torch or touches the card.
_WORKER_DATASET: Optional[StereoDataset] = None
_WORKER_SEED: int = 0


def _process_worker_init(dataset: StereoDataset, seed: int) -> None:
    global _WORKER_DATASET, _WORKER_SEED
    _WORKER_DATASET = dataset
    _WORKER_SEED = seed


def _process_make_item(epoch: int, index: int):
    rng = np.random.default_rng((_WORKER_SEED, epoch, int(index)))
    return _WORKER_DATASET.get_item(int(index), rng)


def _process_make_item_shm(epoch: int, index: int):
    """Like _process_make_item, but returns the numpy payload through a
    POSIX shared-memory segment instead of the result pickle: a gated item
    is ~36 MB. The pipe carries only (name, metadata); the consumer's
    collate copies straight out of the segment (np.stack copies anyway) and
    then unlinks it."""
    from multiprocessing import shared_memory

    item = _process_make_item(epoch, index)
    arrays = {k: v for k, v in item.items() if isinstance(v, np.ndarray)}
    other = {k: v for k, v in item.items() if not isinstance(v, np.ndarray)}
    total = max(1, sum(a.nbytes for a in arrays.values()))
    shm = shared_memory.SharedMemory(create=True, size=total)
    try:
        meta = []
        off = 0
        for k, a in arrays.items():
            view = np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)
            view[...] = a
            meta.append((k, a.shape, str(a.dtype), off))
            off += a.nbytes
    except BaseException:
        shm.close()
        shm.unlink()  # never handed off; reclaim the tmpfs now
        raise
    # Ownership transfers to the consumer, which unlinks after collate; drop
    # this process's resource-tracker registration — only AFTER the payload
    # copy succeeded — so worker exit doesn't double-unlink (the 3.12 stdlib
    # has no track=False yet).
    _shm_untrack(shm)
    shm.close()
    return ("__shm__", shm.name, meta, other)


def _shm_untrack(shm) -> None:
    """Drop a SharedMemory segment from this process's resource tracker
    (no-op if it was never registered). Attaching with create=False
    registers unconditionally on 3.12; after an explicit unlink the
    registration is stale."""
    from multiprocessing import resource_tracker

    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


def _reclaim_shm_result(result) -> None:
    """Best-effort unlink of the shm segment a worker handed off in
    `result` (close-time sweep). Safe against double-unlink (the name is
    gone after the first) and against the consumer still holding views —
    POSIX keeps the mapping alive until the last attachment closes."""
    if isinstance(result, tuple) and len(result) == 4 and result[0] == "__shm__":
        from multiprocessing import shared_memory

        try:
            shm = shared_memory.SharedMemory(name=result[1])
        except Exception:
            return  # already unlinked by the normal drain path
        try:
            shm.close()
            shm.unlink()
            _shm_untrack(shm)
        except Exception:
            pass


# Loaders alive at interpreter exit: their close() sweep reclaims segments
# of completed-but-undrained futures (the daemon producer thread dies with
# the interpreter mid-batch otherwise). WeakSet so the hook never extends a
# loader's lifetime.
_LIVE_LOADERS: "weakref.WeakSet[DataLoader]" = weakref.WeakSet()


@atexit.register
def _atexit_close_loaders() -> None:
    for loader in list(_LIVE_LOADERS):
        try:
            loader.close()
        except Exception:
            pass


def _resolve_shm_item(result):
    """Materialize a worker result: plain dicts pass through; shm-tagged
    results are attached, viewed, and handed to collate as numpy views —
    the segment is unlinked by _collate's caller after stacking."""
    if not (isinstance(result, tuple) and len(result) == 4 and result[0] == "__shm__"):
        return result, None
    from multiprocessing import shared_memory

    _, name, meta, other = result
    shm = shared_memory.SharedMemory(name=name)
    item = dict(other)
    for k, shape, dtype, off in meta:
        item[k] = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf, offset=off)
    return item, shm


def _collate(items) -> Dict[str, np.ndarray]:
    out = {}
    for key in ("image1", "image2", "flow", "valid"):
        out[key] = np.stack([it[key] for it in items])
    out["paths"] = [it.get("paths") for it in items]
    return out


class DataLoader:
    """Iterable over shuffled, augmented, fixed-shape batches.

    For multi-rank training pass (host_id, num_hosts) = (rank, world size):
    each rank walks a disjoint stride of the global shuffled order, and
    every sample's random draws stay keyed on (seed, epoch, index), so the
    ranks' batches together are the samples, augmented the same way, of one
    rank's batch of their total size.

    Process workers return payloads via POSIX shared memory. Graceful
    teardown (close(), GC, normal interpreter exit) sweeps undrained
    segments, but a SIGKILL of the consumer process can strand ~36 MB/item
    of in-flight batches in /dev/shm until reboot — `ls /dev/shm` after a
    hard kill if tmpfs pressure matters.

    Known noise: process workers can print a resource_tracker KeyError
    traceback at exit — a 3.12 stdlib race between the worker's and the
    consumer's register/unregister messages when they share one tracker
    process. Harmless (segments ARE reclaimed; both sides' accounting is
    individually balanced); 3.13's SharedMemory(track=False) removes the
    double bookkeeping entirely."""

    def __init__(
        self,
        dataset: StereoDataset,
        batch_size: int,
        seed: int = 1234,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        host_id: int = 0,
        num_hosts: int = 1,
        worker_type: str = "thread",
        sample_policy: str = "raise",
        sample_retries: int = 2,
        failure_budget: float = 0.05,
    ):
        assert batch_size % 1 == 0 and batch_size > 0
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be 'thread' or 'process', got {worker_type!r}")
        if sample_policy not in SAMPLE_POLICIES:
            raise ValueError(f"sample_policy must be one of {SAMPLE_POLICIES}, got {sample_policy!r}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} out of range for num_hosts {num_hosts}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.worker_type = worker_type
        # Per-sample failure policy (utils/resilience.py; README
        # "Operations"): "raise" aborts the epoch on a decode failure (the
        # reference DataLoader's behavior); "quarantine" retries the sample
        # `sample_retries` more times, then quarantines its index (excluded
        # from future epochs), substitutes a deterministic resample, and
        # counts the drop — hard-failing only when more than
        # `failure_budget` of attempted samples have been dropped.
        self.sample_policy = sample_policy
        self.sample_retries = max(0, sample_retries)
        self.quarantine = SampleQuarantine(failure_budget)
        self.epoch = 0
        # Stream-position bookkeeping for crash-consistent resume
        # (state_dict/load_state_dict): which epoch is being walked, how
        # many batches the CONSUMER has been handed this epoch, and how many
        # batches the next epoch should skip (a restored mid-epoch cursor).
        self._active_epoch: Optional[int] = None
        self._epoch_len = 0
        self._yielded = 0
        self._resume_cursor = 0
        self._pool = None  # lazily created, reused across epochs
        # Futures submitted to process workers whose shm segment has not yet
        # been reclaimed by the producer's drain. close() (also run atexit)
        # sweeps completed entries so a hard stop mid-batch can't strand
        # ~36 MB/item in /dev/shm — workers tracker-unregister segments
        # before handoff, so nothing else would reclaim them. A SIGKILL of
        # this process still leaks whatever was in flight (documented
        # limitation: tmpfs is reclaimed only at reboot in that case).
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()
        _LIVE_LOADERS.add(self)

    def __len__(self) -> int:
        per_host = len(self.dataset) // self.num_hosts
        return per_host // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        order = order[self.host_id :: self.num_hosts]
        if self.quarantine.indices:
            # Quarantined samples never re-enter the stream (their decode
            # fails deterministically), but they are substituted IN PLACE
            # rather than filtered out, so the epoch's batch count (and the
            # stream of every later index) stays the JAX loader's, and every
            # rank keeps the same batch count: a rank with a shorter epoch
            # would leave its peers waiting in a collective step.
            mask = np.isin(order, list(self.quarantine.indices))
            if mask.any():
                healthy = order[~mask]
                if len(healthy) == 0:
                    # Nothing decodable is left to fill a batch with.
                    raise FailureBudgetExceeded("every sample in this rank's shard is quarantined")
                sub = np.random.default_rng((self.seed, 0x51AB, epoch))
                order = order.copy()
                order[mask] = sub.choice(healthy, size=int(mask.sum()))
        return order

    def resilience_stats(self) -> Dict[str, float]:
        """loader/dropped_samples + loader/quarantined counters; the trainer
        merges these into the metrics stream (train/trainer.py fit)."""
        return self.quarantine.stats()

    # --- crash-consistent resume (checkpoint run_state bundle) -----------
    def state_dict(self) -> Dict:
        """The loader's exact stream position + degradation state, captured
        at a checkpoint boundary: (epoch, batch_cursor) addresses the next
        batch the consumer would receive — every index below the cursor has
        already produced an optimizer step the checkpoint contains.

        Shuffle order is a pure function of (seed, epoch), and the
        quarantine substitution streams are keyed on (seed, epoch[, batch]),
        so a restored (epoch, cursor, quarantine set) resumes the IDENTICAL
        sample sequence an uninterrupted run would have walked — proven
        against a control run in tests/test_crash_recovery.py.

        Bounded skew: the served counter advances with the consume cursor,
        but quarantine EVENTS happen at produce time, up to `prefetch`
        batches ahead. A sample first discovered corrupt inside that
        in-flight window is therefore already in the checkpointed set; on
        resume its batch is substituted via the epoch-start mask instead of
        the in-batch recovery path — a different (still deterministic,
        still healthy) substitute for at most that one batch. Quarantining
        a genuinely-corrupt sample "early" is conservative; exact stream
        identity holds for every batch at or before the cursor."""
        if self._active_epoch is None or self._yielded >= self._epoch_len > 0:
            # Between epochs (or the active epoch fully consumed): the next
            # position is the start of the next epoch.
            epoch, cursor = self.epoch, 0
        else:
            epoch, cursor = self._active_epoch, self._yielded
        return {
            "epoch": int(epoch),
            "batch_cursor": int(cursor),
            "quarantine": self.quarantine.state_dict(),
        }

    def load_state_dict(self, state: Dict) -> None:
        """Restore a position captured by state_dict: the next iteration
        walks epoch `state['epoch']` and skips its first `batch_cursor`
        batches WITHOUT decoding them (the skip is on the index chunks, so
        resuming deep into an epoch costs no wasted worker I/O)."""
        self.epoch = int(state.get("epoch", 0))
        self._resume_cursor = max(0, int(state.get("batch_cursor", 0)))
        self._active_epoch = None
        self._yielded = 0
        q = state.get("quarantine")
        if q:
            self.quarantine.load_state_dict(q)

    def set_global_budget_mode(self) -> None:
        """Switch the failure budget from per-rank to pod-global
        enforcement (called by the trainer when pod coordination is
        active): the quarantine keeps counting and substituting but stops
        raising on the local ratio; the trainer enforces the budget on the
        all-reduced counts, so every rank aborts at the same step."""
        if self.quarantine.enforce:
            self.quarantine.enforce = False
            logger.info("loader failure budget switched to pod-global enforcement (rank %d/%d)", self.host_id,
                        self.num_hosts)

    def _make_item(self, epoch: int, index: int):
        rng = np.random.default_rng((self.seed, epoch, int(index)))
        return self.dataset.get_item(int(index), rng)

    def _ensure_pool(self):
        """Worker pool, created once and reused across epochs (a per-epoch
        pool would pay worker spawn + per-worker dataset pickling every
        epoch on the process path)."""
        if self._pool is None:
            if self.worker_type == "process":
                import multiprocessing

                # forkserver, not fork: this pool is created from a process
                # that has started threads and may have initialized CUDA;
                # forked children can inherit held locks and a CUDA context
                # they must not use. The dataset ships to workers via
                # initargs, so no fork-time memory inheritance is needed.
                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("forkserver"),
                    initializer=_process_worker_init,
                    initargs=(self.dataset, self.seed),
                )
            else:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        # Sweep shm segments of futures the producer never drained:
        # completed results carry live segment names; cancelled /
        # pending ones never created a segment. A future RUNNING right now
        # cannot be cancelled and will hand off its segment after this
        # sweep, so wait for it (bounded) and reclaim; skipping it would
        # recreate the exact leak this sweep exists for. The 30 s bound is
        # ONE deadline across the whole sweep, not per future.
        with self._inflight_lock:
            undrained = list(self._inflight)
            self._inflight.clear()
        deadline = time.monotonic() + 30.0
        for f in undrained:
            if f.cancel() or f.cancelled():
                continue
            try:
                result = f.result(timeout=max(0.0, deadline - time.monotonic()))
            except Exception:
                continue  # worker raised, died, or blew the sweep deadline
            _reclaim_shm_result(result)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _produce_batch(self, submit, epoch: int, b: int, chunk, indices) -> Dict[str, np.ndarray]:
        """Submit, drain, degrade, and collate one batch.

        Exception-safe shm lifecycle: drain EVERY future first (a sibling
        decode error must not strand segments workers already handed off —
        they are tracker-unregistered worker-side, nothing else would
        reclaim the tmpfs), then unlink each segment exactly once in the
        finally. Under sample_policy="quarantine" a failed sample is
        retried, quarantined, and substituted instead of aborting the epoch;
        non-Exception failures (CancelledError from close(), executor
        breakage) always abort regardless of policy."""
        futures = [submit(epoch, int(i)) for i in chunk]
        with self._inflight_lock:
            self._inflight.update(futures)
        outcomes = []
        for f in futures:
            try:
                outcomes.append(("ok", f.result()))
            except BaseException as e:  # incl. CancelledError: the drain
                # must survive close()'s cancel_futures so completed
                # siblings' segments still get reclaimed below.
                outcomes.append(("err", e))
        segments = []
        try:
            items_by_pos: Dict[int, dict] = {}
            failures = []
            # Pass 1: attach every SUCCESSFUL payload first. Once a segment
            # is registered in `segments` the finally below owns its
            # reclamation, so the recovery pass is free to raise (e.g.
            # FailureBudgetExceeded) without stranding a sibling's
            # handed-off segment.
            for pos, (status, payload) in enumerate(outcomes):
                if status == "ok":
                    item, shm = _resolve_shm_item(payload)
                    if shm is not None:
                        segments.append(shm)
                    items_by_pos[pos] = item
                else:
                    failures.append((pos, payload))
            # Pass 2: degrade (retry → quarantine → substitute) or abort.
            abort: Optional[BaseException] = None
            resample_rng = None
            for pos, payload in failures:
                # A dead pool (a worker killed, e.g. by a signal sent to
                # the process group) is not a sample's fault: it aborts,
                # and no sample is quarantined for it.
                recoverable = (
                    abort is None
                    and self.sample_policy == "quarantine"
                    and isinstance(payload, Exception)
                    and not isinstance(payload, BrokenExecutor)
                )
                if not recoverable:
                    abort = abort or payload
                    continue
                logger.warning(
                    "sample %d failed to decode: %s", int(chunk[pos]), payload
                )
                if resample_rng is None:
                    # Deterministic per-batch substitute stream, keyed
                    # like every other RNG in this loader.
                    resample_rng = np.random.default_rng(
                        (self.seed, 0x5E5A, epoch, b)
                    )
                recovered = self._recover_sample(
                    submit, epoch, int(chunk[pos]), indices, resample_rng
                )
                item, shm = _resolve_shm_item(recovered)
                if shm is not None:
                    segments.append(shm)
                items_by_pos[pos] = item
            if abort is not None:
                raise abort
            items = [items_by_pos[p] for p in range(len(outcomes))]
            # served is counted at CONSUME time (__iter__, next to the
            # stream cursor), not here at produce time: the prefetch queue
            # runs ahead of the consumer, and a checkpoint snapshotting
            # produce-time counters with a consume-time cursor would
            # double-count the in-flight window on every resume.
            return _collate(items)
        finally:
            for shm in segments:
                try:
                    shm.close()
                    shm.unlink()
                    # attach re-registered the segment with THIS process's
                    # resource tracker (3.12 stdlib); drop it so tracker
                    # state stays bounded and exit emits no spurious leak
                    # warnings.
                    _shm_untrack(shm)
                except Exception:
                    pass
            with self._inflight_lock:
                self._inflight.difference_update(futures)

    def _recover_sample(self, submit, epoch: int, index: int, indices, rng):
        """Per-sample degradation: retry `index` sample_retries more times,
        then quarantine it and draw substitute indices until one decodes.
        Returns the raw worker payload; raises FailureBudgetExceeded when
        the dropped fraction crosses the budget, or when nothing decodable
        remains to substitute."""

        def attempt(idx: int, tries: int):
            last: Optional[BaseException] = None
            for _ in range(tries):
                f = submit(epoch, idx)
                with self._inflight_lock:
                    self._inflight.add(f)
                try:
                    result = f.result()
                    return result
                except BrokenExecutor:
                    raise
                except Exception as e:
                    last = e
                finally:
                    with self._inflight_lock:
                        self._inflight.discard(f)
            raise last  # type: ignore[misc]

        if self.sample_retries > 0:
            try:
                return attempt(index, self.sample_retries)
            except BrokenExecutor:
                raise
            except Exception:
                pass
        # sample_retries=0: straight to quarantine (the caller's initial
        # attempt already failed; "retries per sample" means extra attempts)
        self.quarantine.quarantine(index)  # may raise FailureBudgetExceeded
        candidates = np.asarray(indices)
        candidates = candidates[~np.isin(candidates, list(self.quarantine.indices))]
        while len(candidates):
            sub = int(rng.choice(candidates))
            try:
                payload = attempt(sub, 1 + self.sample_retries)
                logger.warning("substituted sample %d for quarantined %d", sub, index)
                return payload
            except BrokenExecutor:
                raise
            except Exception:
                self.quarantine.quarantine(sub)
                candidates = candidates[candidates != sub]
        raise FailureBudgetExceeded(
            f"no decodable substitute remains for sample {index} "
            f"({len(self.quarantine.indices)} quarantined)"
        )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        self.epoch += 1
        indices = self._epoch_indices(epoch)
        # len(self): every rank walks the same number of batches even where
        # the dataset does not split evenly over the ranks.
        n_batches = len(self)
        if n_batches == 0:
            return
        # Restored mid-epoch cursor (load_state_dict): skip the batches the
        # checkpointed run already consumed — on the INDEX chunks, so no
        # decode work is wasted. One-shot: later epochs start from 0.
        skip = self._resume_cursor
        self._resume_cursor = 0
        if skip >= n_batches:
            # Only reachable when the dataset shrank between save and
            # restore (config drift) — stream-exact resume is impossible;
            # restart the epoch rather than yielding nothing.
            logger.warning(
                "restored batch cursor %d >= %d batches in epoch %d "
                "(dataset shrank since the checkpoint?); restarting the epoch",
                skip, n_batches, epoch,
            )
            skip = 0
        self._active_epoch = epoch
        self._epoch_len = n_batches
        self._yielded = skip

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        pool = self._ensure_pool()
        if self.worker_type == "process":
            submit = lambda e, i: pool.submit(_process_make_item_shm, e, int(i))
        else:
            submit = lambda e, i: pool.submit(self._make_item, e, i)

        def producer():
            for b in range(skip, n_batches):
                if stop.is_set():
                    break
                chunk = indices[b * self.batch_size : (b + 1) * self.batch_size]
                try:
                    q.put(self._produce_batch(submit, epoch, b, chunk, indices))
                except BaseException as e:  # propagate decode errors to consumer
                    if isinstance(e, BrokenExecutor):
                        # Drop the cached pool only when the pool itself died
                        # (worker OOM-killed / segfaulted) — an ordinary
                        # decode error shouldn't tear down healthy workers.
                        self.close()
                    if not isinstance(e, Exception):
                        # CancelledError/SystemExit are BaseException: wrap
                        # so the queue error path and the consumer's
                        # isinstance(item, Exception) check still function.
                        e = RuntimeError(f"worker aborted: {e!r}")
                    q.put(e)
                    break
            q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    # Epoch fully consumed: the stream position rolls to the
                    # start of the next epoch (state_dict reads self.epoch).
                    # A mid-epoch abandonment (preemption stop, rollback
                    # break) never reaches here, so _active_epoch/_yielded
                    # keep pointing at the interrupted position — exactly
                    # what the final checkpoint must record.
                    self._active_epoch = None
                    break
                if isinstance(item, Exception):
                    raise item
                # Count the hand-off BEFORE yielding: once the consumer has
                # the batch it will step on it, so a checkpoint taken inside
                # the consumer's loop body must see the cursor past it. The
                # served counter advances in lockstep with the cursor for
                # the same reason.
                self._yielded += 1
                self.quarantine.record_served(self.batch_size)
                yield item
        finally:
            stop.set()
            # Drain so a producer blocked in q.put can observe `stop`, then
            # reap it — bounded, because a decode wedged in native code must
            # not hang teardown (the thread is a daemon either way; the
            # bound just converts "abandoned" into "reaped or abandoned
            # after 5 s", so producer exceptions can't outlive the epoch).
            reap_deadline = time.monotonic() + 5.0
            while thread.is_alive() and time.monotonic() < reap_deadline:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)
