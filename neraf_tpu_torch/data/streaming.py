"""The audio data path for splits too large for the device (counterpart of
neraf_tpu/data/streaming.py): the (N, C, F, T) log-STFT stays in host
memory (an ndarray or a np.memmap), the (N, 3) pose tables live on the
device, and a producer thread draws (recording, time bin) pairs and
gathers their (C, F) columns on the host.

- The producer does host work only: it draws as the JAX sampler draws
  (np.random.default_rng(seed), the same integers, the same lexsort
  gather order and unsort, so a seed gives the JAX sampler's indices and
  columns) and writes each batch into a pinned host buffer, converting to
  the transfer dtype there (torch releases the GIL in the copy).
- The training thread, the only one that touches the card, issues each
  batch's host-to-device copy on a stream of its own, makes the compute
  stream wait for the copy's event before the batch is used, and marks the
  device tensors as used on the compute stream (record_stream), so the
  caching allocator keeps them until the step that reads them is done.
  `next()` returns the oldest batch in flight and starts the copies of
  the next `inflight` ones, which then overlap the step that consumes it.
- The pinned buffers are a ring allocated once on the training thread; a
  buffer goes back to the producer only after its copy's event has
  completed.

On the CPU (device="cpu", asked for explicitly) there are no pinned
buffers and no streams: the producer's tensors are the batch.

Under a data mesh (parallel/sharding.py) every rank's sampler, seeded
alike, draws the same global (recording, time bin) sequence, and each
gathers and copies only its rank's contiguous block of the batch's
columns: the block that the rank's share of the resident step would
gather.

A batch is {"data" (B, C, F) in the transfer dtype, "audio_idx",
"time_query" (B,) int64, and the pose tables "mic_pose", "source_pose",
"rot" (N, 3) float32}, which data/loader.py::resolve_audio_batch turns into
the batch the device-resident path gathers (poses gathered and data upcast
to float32 on the device).
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np
import torch

from neraf_tpu_torch.parallel.sharding import block_range, shard_batch

_TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def split_device_bytes(log_stft) -> int:
    """Device bytes the device-resident path would commit for this split."""
    return int(np.prod(log_stft.shape)) * log_stft.dtype.itemsize


def write_time_major_store(log_stft, path, block: int = 256) -> np.memmap:
    """A (N, C, F, T) split -> a (N, T, C, F) float32 store on disk, written
    `block` recordings at a time: each (C, F) column the sampler gathers is
    then one contiguous read instead of C*F elements T floats apart."""
    n = log_stft.shape[0]
    tm_shape = (n, log_stft.shape[3], log_stft.shape[1], log_stft.shape[2])
    mm = np.memmap(path, np.float32, "w+", shape=tm_shape)
    for i in range(0, n, block):
        mm[i:i + block] = np.asarray(log_stft[i:i + block]).transpose(0, 3, 1, 2)
    mm.flush()
    return np.memmap(path, np.float32, "r", shape=tm_shape)


def should_stream(audio_cfg, dataset) -> bool:
    """"on" / "off" / "auto": auto streams when the split's log-STFT
    exceeds stream_threshold_gb (the device also holds the weights, Adam
    states, the grid and the ResNet's activations)."""
    mode = audio_cfg.streaming
    if mode == "on":
        return True
    if mode == "off":
        return False
    threshold = float(audio_cfg.stream_threshold_gb)
    return split_device_bytes(dataset.log_stft) > threshold * 2**30


class StreamingAudioSampler:
    """Host-gathered STFT-column batches, copied to `device` ahead of use.

        with StreamingAudioSampler(split, batch_size, device=dev) as s:
            for _ in range(steps):
                pipe.train_step(cams, s.next(), images)

    The store: layout="tcf" takes a time-major (N, T, C, F) store as it is
    (write_time_major_store); otherwise time_major=True, or "auto" on an
    in-memory ndarray, transposes the (N, C, F, T) store once at init
    ("auto" leaves a memmap as it is: transposing it would read the whole
    store through memory). transfer_dtype "bfloat16" halves the bytes a
    batch at a relative rounding of at most 2^-8.

    `gather_ms` and `copy_ms()` keep the producer's gather time and the
    copies' device time of the latest batches.

    With a data mesh (`mesh`), a batch is this rank's block of the
    global draw's columns (parallel/sharding.py::partition: ceil(batch_size
    / N) columns, the last blocks shorter).
    """

    def __init__(self, dataset, batch_size: int, max_len: int | None = None,
                 seed: int = 0, prefetch: int = 3,
                 transfer_dtype: str = "float32",
                 time_major: bool | str = "auto", layout: str = "cft",
                 inflight: int = 2, device="cuda", mesh=None):
        if transfer_dtype not in _TRANSFER_DTYPES:
            raise ValueError(f"unsupported transfer_dtype {transfer_dtype!r}")
        self.mesh = mesh
        self.log_stft = dataset.log_stft
        self._tm = layout == "tcf"
        if not self._tm and (time_major is True or (
                time_major == "auto" and type(self.log_stft) is np.ndarray)):
            self.log_stft = np.ascontiguousarray(
                np.asarray(self.log_stft).transpose(0, 3, 1, 2))
            self._tm = True
        self._dtype = _TRANSFER_DTYPES[transfer_dtype]
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        o = dataset.outputs
        self.pose_tables = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for k, v in (("mic_pose", o.microphone_poses),
                         ("source_pose", o.source_poses),
                         ("rot", o.rotations))}
        self.batch_size = batch_size
        self.max_len = int(max_len if max_len is not None else dataset.max_len)
        shape = self.log_stft.shape
        self._cf = shape[2:] if self._tm else shape[1:3]
        self._rng = np.random.default_rng(seed)
        self._host_q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._inflight_max = max(1, int(inflight))
        self._inflight: list = []  # (device batch, buffer index), oldest first
        self._stopped = threading.Event()
        self._error: BaseException | None = None
        self.gather_ms: collections.deque = collections.deque(maxlen=256)
        self._copy_events: collections.deque = collections.deque(maxlen=256)
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            # the host queue, the copies in flight, the batch being
            # returned and the producer's: no buffer is waited for while a
            # copy could still read it
            n_buf = max(1, prefetch) + self._inflight_max + 2
            self._buffers = [self._host_buffer(pin=True) for _ in range(n_buf)]
            self._free: queue.Queue = queue.Queue()
            for i in range(n_buf):
                self._free.put(i)
            self._copying: list = []  # (copy done event, buffer index)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _host_buffer(self, pin: bool) -> dict:
        lo, hi = block_range(self.batch_size, self.mesh)
        B = hi - lo
        return {"data": torch.empty((B, *self._cf), dtype=self._dtype,
                                    pin_memory=pin),
                "idx": torch.empty((2, B), dtype=torch.int64, pin_memory=pin)}

    # ------------------------------------------------------------ producer
    def _draw_host_batch(self) -> tuple:
        """(rec, t) int32 and the (B, C, F) float32 columns, drawn and
        gathered as the JAX sampler's _draw_host_batch."""
        n_rec = self.log_stft.shape[0]
        idx = self._rng.integers(0, n_rec * self.max_len, self.batch_size)
        rec, t = shard_batch(((idx // self.max_len).astype(np.int32),
                              (idx % self.max_len).astype(np.int32)), self.mesh)
        # sorted order for page locality (a memmap's), then unsorted
        order = np.lexsort((t, rec))
        inv = np.argsort(order)
        if self._tm:
            data = self.log_stft[rec[order], t[order]][inv]
        else:
            data = self.log_stft[rec[order], :, :, t[order]][inv]
        return rec, t, np.ascontiguousarray(data, dtype=np.float32)

    def _take_buffer(self):
        """A free pinned buffer (None once stopped); on the CPU a new one."""
        if not self._cuda:
            return None, self._host_buffer(pin=False)
        while not self._stopped.is_set():
            try:
                i = self._free.get(timeout=0.2)
                return i, self._buffers[i]
            except queue.Empty:
                continue
        return None, None

    def _producer(self):
        try:
            while not self._stopped.is_set():
                t0 = time.perf_counter()
                rec, t, data = self._draw_host_batch()
                i, buf = self._take_buffer()
                if buf is None:
                    return
                buf["data"].copy_(torch.from_numpy(data))
                buf["idx"][0].copy_(torch.from_numpy(rec))
                buf["idx"][1].copy_(torch.from_numpy(t))
                self.gather_ms.append((time.perf_counter() - t0) * 1e3)
                while not self._stopped.is_set():
                    try:
                        self._host_q.put((i, buf), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced by next(); never deadlock it
            self._error = e

    # ------------------------------------------------------------ consumer
    def _release_copied(self) -> None:
        """Hand the buffers whose copies have completed back to the
        producer (one stream: they complete in order)."""
        while self._copying and self._copying[0][0].query():
            self._free.put(self._copying.pop(0)[1])

    def _get_host_batch(self, block: bool):
        while True:
            if self._cuda:
                self._release_copied()
            try:
                return (self._host_q.get(timeout=0.05) if block
                        else self._host_q.get_nowait())
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError(
                        "streaming producer thread died") from self._error
                if not block:
                    return None

    def _start_transfer(self, host) -> dict:
        i, buf = host
        if not self._cuda:
            return {"data": buf["data"], "audio_idx": buf["idx"][0],
                    "time_query": buf["idx"][1]}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            start.record()
            data = buf["data"].to(self.device, non_blocking=True)
            idx = buf["idx"].to(self.device, non_blocking=True)
            done.record()
        self._copying.append((done, i))
        self._copy_events.append((start, done))
        return {"data": data, "audio_idx": idx[0], "time_query": idx[1],
                "_copied": done}

    def next(self) -> dict:
        """The next batch (training thread only): its copy ordered before
        the compute stream's later work, and the copies of the following
        batches started."""
        if not self._inflight:
            self._inflight.append(self._start_transfer(self._get_host_batch(True)))
        out = self._inflight.pop(0)
        while len(self._inflight) < self._inflight_max:
            nb = self._get_host_batch(False)
            if nb is None:
                break
            self._inflight.append(self._start_transfer(nb))
        if self._cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(out.pop("_copied"))
            for k in ("data", "audio_idx", "time_query"):
                out[k].record_stream(compute)
        out.update(self.pose_tables)
        return out

    def copy_ms(self) -> list:
        """The device time of each of the latest completed batch copies."""
        return [a.elapsed_time(b) for a, b in self._copy_events if b.query()]

    def stop(self):
        self._stopped.set()
        self._thread.join(timeout=5)
        if self._cuda:
            self._copy_stream.synchronize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
