"""Micro-batching matcher service on the card (``loftr_tpu.serve.service``).

- **Buckets.** Requests are resized (aspect-preserving, /8-divisible) and
  bottom-right zero-padded into a fixed set of resolution buckets with
  validity masks, the MegaDepth path of ``data/io.py``.  A batch whose
  masks are all true goes without masks (the same function; the kernels'
  unmasked path).
- **Batch rungs.** A pending group of n requests is padded up to the
  smallest rung of ``batch_sizes``; padding rows are zero images with empty
  masks, and their outputs are dropped.
- **Pipelined dispatch.** A PyTorch forward is issued by the host, so the
  overlap comes from threads: a small pool stacks batch N+1 into pinned
  host tensors and starts its non-blocking host-to-device copy while the
  dispatcher issues batch N; after each forward the dispatcher starts one
  non-blocking copy of the whole result (one packed tensor: valid, mconf
  and both keypoint sets) into a pinned host tensor and records a
  ``torch.cuda.Event``; the completer waits on that event, never on
  ``torch.cuda.synchronize()``, and resolves the futures.  A bounded
  in-flight queue (``queue_depth``) applies back-pressure.  Every copy and
  forward goes to one CUDA stream the service owns, so a batch's input
  copy is ordered before its forward.  Pinned blocks come from PyTorch's
  caching host allocator, which records an event for each non-blocking
  copy and hands a block out again only once that event has completed.
  The client threads, the stacking pool, the dispatcher and the completer
  share the GIL: the forward's host time is the service's bottleneck at
  small rungs, and the others overlap with it only where they wait on the
  card or on the kernels' host-side work releases the GIL.
- **Inference mode** is per thread in PyTorch: each thread that launches
  work enters it around its calls.
- **Wire.** ``wire_dtype="uint8"`` ships images as bytes and divides by
  255 in float32 on the card, which equals the host-side division of
  ``api.match_pair`` bit for bit.
- **Errors.** A forward that raises fails every future of its group, and
  the service goes on; it never answers from another path.

- **Several devices.** ``mesh={"data": [device, ...]}`` (this process's
  devices, ``parallel.mesh.local_device_mesh``) holds one model replica a
  device: each batch's rows are split evenly over the devices (every rung
  is rounded up to a multiple of their count), each shard is copied,
  matched and fetched on its device's own stream, and the completer joins
  the shards' results in row order.  The two-image packing is
  ``interleave``, as in JAX's meshed service.

Latency/throughput knobs: ``flush_ms`` (how long the oldest request waits
for batch-mates), ``batch_sizes``, ``buckets``, ``queue_depth``,
``stack_workers``, ``max_hold_ms``, ``mesh``.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from loftr_tpu_torch.data.io import get_divisible_wh

Bucket = Tuple[int, int]  # (H, W), both divisible by 8


def _to_gray(img, wire_dtype=np.float32) -> np.ndarray:
    """HxW / HxWx1 / HxWx3(BGR) uint8/float -> HxW grayscale.

    wire_dtype float32: values in [0, 1].  wire_dtype uint8: values in
    [0, 255]; the /255 normalisation happens on the card."""
    a = np.asarray(img)
    was_uint8 = a.dtype == np.uint8
    if a.ndim == 3 and a.shape[-1] == 3:
        # the BGR matmul promotes uint8 to float32 but keeps the [0, 255]
        # range: normalise by the input dtype, not the product's
        a = a @ np.asarray([0.114, 0.587, 0.299],
                           np.float32 if was_uint8 else a.dtype)
        if was_uint8:
            a = a / 255.0
    a = a.reshape(a.shape[:2])
    if wire_dtype == np.uint8:
        if a.dtype == np.uint8:
            return a
        return np.clip(np.round(np.asarray(a, np.float32) * 255.0),
                       0, 255).astype(np.uint8)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    return np.asarray(a, np.float32)


def pick_bucket(buckets: Sequence[Bucket], shapes: Sequence[Tuple[int, int]]
                ) -> Bucket:
    """Smallest-area bucket that holds every (h, w) in ``shapes`` at native
    resolution; if none fits, the largest bucket (images are downscaled)."""
    order = sorted(buckets, key=lambda b: b[0] * b[1])
    for bh, bw in order:
        if all(h <= bh and w <= bw for h, w in shapes):
            return (bh, bw)
    return order[-1]


def preprocess_to_bucket(img: np.ndarray, bucket: Bucket):
    """Fit a grayscale image into ``bucket``: aspect-preserving resize
    (never upscales), floor to /8-divisible, bottom-right zero-pad.

    Returns (padded [bh, bw] in the input dtype, coarse mask [bh/8, bw/8]
    bool, scale [2] float32 = [w/w_new, h/h_new])."""
    import cv2

    bh, bw = bucket
    h, w = img.shape
    s = min(bh / h, bw / w, 1.0)
    w_new, h_new = get_divisible_wh(int(w * s), int(h * s), 8)
    w_new, h_new = max(w_new, 8), max(h_new, 8)
    if (w_new, h_new) != (w, h):
        img = cv2.resize(img, (w_new, h_new))
    scale = np.array([w / w_new, h / h_new], np.float32)
    padded = np.zeros((bh, bw), img.dtype)  # uint8 stays uint8 on the wire
    padded[:h_new, :w_new] = img
    mask = np.zeros((bh // 8, bw // 8), bool)
    mask[: h_new // 8, : w_new // 8] = True
    return padded, mask, scale


@dataclass
class _Request:
    img0: np.ndarray       # [bh, bw] wire dtype (uint8/float32), padded
    img1: np.ndarray
    mask0: np.ndarray      # [bh/8, bw/8] bool
    mask1: np.ndarray
    scale0: np.ndarray     # [2] float32
    scale1: np.ndarray
    min_conf: float
    future: Future
    t_submit: float


def _safe_resolve(fut: Future, result=None, exc=None) -> None:
    """Resolve a client future, tolerating a client-side ``cancel()``.

    Submitted futures are never marked running, so a client's cancel()
    succeeds on a pending future; set_result/set_exception then raise
    ``InvalidStateError``.  That one error is dropped (the client no
    longer wants the result); any other raises."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass  # cancelled or already resolved by the client


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    batch_hist: Dict[int, int] = field(default_factory=dict)
    latencies_ms: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=2048))
    # per-batch pipeline phases (ms, host clock): 'stack' host assembly
    # into pinned tensors, 'place' the host-to-device copies' issue,
    # 'dispatch' the forward's issue and the result copy's, 'fetch' the
    # completer's wait for the result copy and the split
    phase_ms: Dict[str, collections.deque] = field(
        default_factory=lambda: collections.defaultdict(
            lambda: collections.deque(maxlen=2048)))
    # guards the deques against the stack pool, dispatcher and completer
    lock: threading.Lock = field(default_factory=threading.Lock)

    def record_phase(self, phase: str, ms: float) -> None:
        with self.lock:
            self.phase_ms[phase].append(ms)

    def reset(self) -> None:
        """Zero all counters and histograms (e.g. between bench levels)."""
        with self.lock:
            self.requests = self.batches = self.padded_rows = 0
            self.batch_hist.clear()
            self.latencies_ms.clear()
            self.phase_ms.clear()

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            phase = {k: list(v) for k, v in self.phase_ms.items()}
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "padded_rows": self.padded_rows,
                "batch_hist": dict(self.batch_hist),
            }
        pct = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
               if lat else None)
        out["latency_ms_p50"] = pct(0.50)
        out["latency_ms_p99"] = pct(0.99)
        out["phase_ms_mean"] = {
            k: round(float(np.mean(v)), 3)
            for k, v in phase.items() if len(v)}
        return out


class MatchingService:
    """Thread-safe micro-batching wrapper around one LoFTR matcher.

    >>> svc = MatchingService(state_dict)         # doctest: +SKIP
    >>> fut = svc.submit(img0, img1)              # doctest: +SKIP
    >>> fut.result()["mkpts0"]                    # doctest: +SKIP
    """

    def __init__(self, weights: Mapping[str, torch.Tensor],
                 preset: str = "indoor_ds", dtype: str = "bfloat16",
                 use_pallas: bool = True, overrides: Optional[dict] = None,
                 buckets: Sequence[Bucket] = ((480, 640), (840, 840)),
                 batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 flush_ms: float = 5.0, queue_depth: int = 2,
                 mesh=None, wire_dtype: str = "uint8",
                 stack_workers: int = 2, max_hold_ms: float = 100.0,
                 device="cuda"):
        """weights: a port state dict, as it is or through
        ``api.optimize_variables``: the backbone's norm and dims are read
        off it (``infer_backbone_overrides``), ``overrides`` (a
        ``{"loftr": ...}`` dict) win over the serving defaults.

        wire_dtype: 'uint8' ships images as bytes and normalises /255 on
        the card; 'float32' ships [0, 1] floats.

        stack_workers: > 0 stacks and places batches in a pool while the
        dispatcher issues the previous ones; 0 keeps one batcher thread.

        max_hold_ms: how long a partial rung may be held past ``flush_ms``
        while the pipeline is saturated (the saturation gate trades flush
        latency for full rungs under load); bounds cross-bucket
        starvation.

        mesh: ``{"data": [device, ...]}``: one replica a device, each
        batch's rows split over them (rungs rounded up to multiples of
        their count); ``device`` is then ignored."""
        import copy

        from loftr_tpu_torch.api import resolve_device
        from loftr_tpu_torch.config import get_config
        from loftr_tpu_torch.models.matcher import LoFTR
        from loftr_tpu_torch.utils.channel_pad import \
            infer_backbone_overrides

        if mesh is not None:
            if "data" not in mesh or not len(mesh["data"]):
                raise ValueError("serving mesh needs a 'data' axis of "
                                 "devices")
            devices = [resolve_device(d) for d in mesh["data"]]
            if len({d.type for d in devices}) != 1:
                raise ValueError(f"mesh devices of several types: {devices}")
        else:
            devices = [resolve_device(device)]
        for bh, bw in buckets:
            if bh % 8 or bw % 8:
                raise ValueError(f"bucket {(bh, bw)} not /8-divisible")
        self.devices = devices
        self.device = devices[0]
        ov = {"loftr": {"dtype": dtype,
                        "match_coarse": {"use_pallas": use_pallas},
                        "fine": {"use_pallas": use_pallas},
                        **infer_backbone_overrides(weights)}}
        if mesh is not None:
            # shard-local two-image packing, as JAX's meshed service
            ov["loftr"]["batch_packing"] = "interleave"
        if overrides:
            # caller overrides win over the serving defaults
            ov_loftr = dict(ov["loftr"])
            for k, v in overrides.get("loftr", {}).items():
                if isinstance(v, dict) and isinstance(ov_loftr.get(k), dict):
                    ov_loftr[k] = {**ov_loftr[k], **v}
                else:
                    ov_loftr[k] = v
            ov = {**overrides, "loftr": ov_loftr}
        self.config = get_config(preset, ov)
        model = LoFTR(self.config.loftr)
        model.load_state_dict(weights)
        model.eval()
        # one replica a device (the last takes the loaded module itself)
        self._models = [copy.deepcopy(model).to(d) for d in devices[:-1]]
        self._models.append(model.to(devices[-1]))
        self._wire = np.uint8 if wire_dtype == "uint8" else np.float32
        self._cuda = self.device.type == "cuda"
        self._streams = [torch.cuda.Stream(d) if self._cuda else None
                         for d in devices]
        self._255 = [torch.tensor(255.0, device=d) for d in devices]
        self.buckets = tuple((int(h), int(w)) for h, w in buckets)
        # every rung splits evenly over the devices: round up, dedup
        ns = len(devices)
        self.batch_sizes = tuple(sorted({-(-int(b) // ns) * ns
                                         for b in batch_sizes}))
        self.max_batch = self.batch_sizes[-1]
        self.flush_s = flush_ms / 1000.0
        self.max_hold_s = max(max_hold_ms, flush_ms) / 1000.0
        self.stats = ServiceStats()

        self._lock = threading.Condition()
        self._pending: Dict[Bucket, List[_Request]] = {
            b: [] for b in self.buckets}
        self._inflight: "collections.deque" = collections.deque()
        self._inflight_sem = threading.Semaphore(queue_depth)
        self._queue_depth = queue_depth
        # groups taken from _pending and not yet completed.  Gates the
        # age-based partial-rung flush: when the pipeline is saturated
        # (busy >= queue_depth) a partial batch would only wait in a host
        # queue, so holding it for a full rung costs no latency and saves
        # padded rows.
        self._busy = 0
        self._inflight_cv = threading.Condition()
        self._closed = False
        self._stack_workers = max(0, int(stack_workers))
        self._stack_pool = None
        self._prepared = None
        self._dispatcher = None
        if self._stack_workers:
            import queue
            from concurrent.futures import ThreadPoolExecutor
            self._stack_pool = ThreadPoolExecutor(
                self._stack_workers, thread_name_prefix="loftr-serve-stack")
            # FIFO of stack-pool futures; bounded so host staging stays
            # O(stack_workers) batches ahead of the card
            self._prepared = queue.Queue(maxsize=self._stack_workers + 1)
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="loftr-serve-dispatcher",
                daemon=True)
            self._dispatcher.start()
        self._batcher = threading.Thread(
            target=self._batch_loop, name="loftr-serve-batcher", daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="loftr-serve-completer",
            daemon=True)
        self._batcher.start()
        self._completer.start()

    # ------------------------------------------------------------- public
    def submit(self, img0, img1, min_conf: float = 0.0,
               bucket: Optional[Bucket] = None) -> Future:
        """Enqueue one pair; the Future resolves to
        dict(mkpts0 [M,2], mkpts1 [M,2], mconf [M]) in original-image px."""
        if self._closed:
            raise RuntimeError("service is closed")
        g0 = _to_gray(img0, self._wire)
        g1 = _to_gray(img1, self._wire)
        b = bucket or pick_bucket(self.buckets, [g0.shape, g1.shape])
        if b not in self._pending:
            raise ValueError(f"unknown bucket {b}")
        p0, m0, s0 = preprocess_to_bucket(g0, b)
        p1, m1, s1 = preprocess_to_bucket(g1, b)
        fut: Future = Future()
        req = _Request(p0, p1, m0, m1, s0, s1, min_conf, fut, time.time())
        with self._lock:
            self._pending[b].append(req)
            self._lock.notify_all()
        return fut

    def match(self, img0, img1, min_conf: float = 0.0) -> dict:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(img0, img1, min_conf).result()

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """One forward of every (bucket, rung), masked and unmasked, each
        fetched: cuDNN's algorithm choice and the kernel library's build
        happen here instead of in the first requests."""
        ns = len(self.devices)
        for bh, bw in self.buckets:
            for n in (batch_sizes or self.batch_sizes):
                n = -(-int(n) // ns) * ns
                for full in (True, False):
                    mask = np.ones((bh // 8, bw // 8), bool)
                    mask[:, -1] = full
                    img = np.zeros((bh, bw, 1), self._wire)
                    one = np.ones(2, np.float32)
                    inp = self._place(*(self._host([a] * n) for a in (
                        img, img, mask, mask, one, one)))
                    host, event = self._launch(inp)
                    self._finish(host, event)

    def close(self, timeout: float = 30.0) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        with self._inflight_cv:
            self._inflight_cv.notify_all()
        self._batcher.join(timeout)
        if self._dispatcher is not None:
            self._dispatcher.join(timeout)
        if self._stack_pool is not None:
            self._stack_pool.shutdown(wait=False)
        self._completer.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------- batcher side
    def _take_group(self) -> Optional[Tuple[Bucket, List[_Request]]]:
        """Block until a dispatchable group exists (full rung, or the oldest
        request aged past flush_ms); None when closing and drained."""
        def take(b, reqs):
            group = reqs[: self.max_batch]
            del reqs[: self.max_batch]
            self._busy += 1
            return b, group

        with self._lock:
            while True:
                now = time.time()
                oldest_b, oldest_t = None, None
                for b, reqs in self._pending.items():
                    if reqs and (oldest_t is None
                                 or reqs[0].t_submit < oldest_t):
                        oldest_b, oldest_t = b, reqs[0].t_submit
                # 1) a request held past max_hold_s beats full rungs in
                #    other buckets: under continuous full-rung pressure in
                #    one bucket a lone request elsewhere would otherwise
                #    wait for the whole burst
                if (oldest_b is not None
                        and now - oldest_t >= self.max_hold_s):
                    return take(oldest_b, self._pending[oldest_b])
                # 2) any full rung dispatches immediately
                for b, reqs in self._pending.items():
                    if len(reqs) >= self.max_batch:
                        return take(b, reqs)
                if oldest_b is not None:
                    wait = oldest_t + self.flush_s - now
                    if wait <= 0 or self._closed:
                        # 3) age-based partial-rung flush, only when the
                        # pipeline can start it (busy < queue_depth) or on
                        # close; otherwise hold for a full rung, a
                        # completion (_group_done notifies) or max_hold_s
                        if self._closed or self._busy < self._queue_depth:
                            return take(oldest_b, self._pending[oldest_b])
                        self._lock.wait(oldest_t + self.max_hold_s - now)
                    else:
                        self._lock.wait(wait)
                elif self._closed:
                    return None
                else:
                    self._lock.wait()

    def _group_done(self) -> None:
        """A taken group finished (completed or failed): unblock a
        partial-rung flush waiting on pipeline capacity."""
        with self._lock:
            self._busy -= 1
            self._lock.notify_all()

    def _fail(self, group: List[_Request], exc: BaseException) -> None:
        for r in group:
            _safe_resolve(r.future, exc=exc)
        self._group_done()

    def _host(self, rows: List[np.ndarray]) -> torch.Tensor:
        """``rows`` stacked into one host tensor, pinned on the card's
        path (the non-blocking copy needs pinned memory)."""
        if not self._cuda:
            return torch.from_numpy(np.stack(rows))
        buf = torch.empty((len(rows),) + rows[0].shape,
                          dtype=torch.from_numpy(rows[0][:0]).dtype,
                          pin_memory=True)
        np.stack(rows, out=buf.numpy())
        return buf

    def _place(self, img0, img1, mask0, mask1, scale0, scale1):
        """Stacked host tensors -> a MatchInput on the device, copied
        without blocking on the service's stream.  Masks that are all true
        are left out (the same function).  With several devices, a list of
        MatchInputs: each device's rows, on its own stream."""
        from loftr_tpu_torch.structs import MatchInput

        t0 = time.perf_counter()
        host = dict(image0=img0, image1=img1, scale0=scale0, scale1=scale1)
        if not (bool(mask0.all()) and bool(mask1.all())):
            host.update(mask0=mask0, mask1=mask1)
        n = len(self.devices)
        rows = img0.shape[0] // n
        shards = []
        for i, (dev, stream) in enumerate(zip(self.devices, self._streams)):
            part = {k: v[i * rows:(i + 1) * rows] if n > 1 else v
                    for k, v in host.items()}
            if self._cuda:
                with torch.cuda.stream(stream):
                    part = {k: v.to(dev, non_blocking=True)
                            for k, v in part.items()}
            shards.append(MatchInput(**part))
        self.stats.record_phase("place", (time.perf_counter() - t0) * 1e3)
        return shards if n > 1 else shards[0]

    def _prepare(self, b: Bucket, group: List[_Request], rung: int):
        """Host batch assembly and placement (in the stack pool when
        pipelined, inline otherwise).  Returns a MatchInput on the
        device."""
        bh, bw = b
        n = len(group)
        t0 = time.perf_counter()

        def stack(attr, pad_shape, dtype):
            rows = [getattr(r, attr) for r in group]
            rows += [np.zeros(pad_shape, dtype)] * (rung - n)
            return self._host(rows)

        tensors = (stack("img0", (bh, bw), self._wire)[..., None],
                   stack("img1", (bh, bw), self._wire)[..., None],
                   stack("mask0", (bh // 8, bw // 8), bool),
                   stack("mask1", (bh // 8, bw // 8), bool),
                   stack("scale0", (2,), np.float32),
                   stack("scale1", (2,), np.float32))
        self.stats.record_phase("stack", (time.perf_counter() - t0) * 1e3)
        return self._place(*tensors)

    def _forward(self, inp, i: int = 0):
        """Device ``i``'s matcher on one placed batch.  uint8 images are
        divided by 255 in float32 on the device, by a tensor: PyTorch
        multiplies by the reciprocal when the divisor is a Python number,
        which is not the host's division bit for bit."""
        if inp.image0.dtype == torch.uint8:
            inp.image0 = inp.image0.float() / self._255[i]
            inp.image1 = inp.image1.float() / self._255[i]
        return self._models[i](inp)

    def _launch(self, inp):
        """Issue the forward, then one non-blocking copy of the packed
        result ([B, K, 6] float32: valid, mconf, mkpts0_f, mkpts1_f) into
        a pinned host tensor, and record an event after it.  Returns
        (host tensor, event or None on the CPU); with several devices
        (``inp`` a list), (a host tensor a device, an event a device)."""
        if isinstance(inp, list):
            out = [self._launch_on(i, x) for i, x in enumerate(inp)]
            return [h for h, _ in out], [e for _, e in out]
        return self._launch_on(0, inp)

    def _launch_on(self, i: int, inp):
        with torch.inference_mode():
            if not self._cuda:
                return self._pack(self._forward(inp, i)), None
            stream = self._streams[i]
            with torch.cuda.stream(stream):
                packed = self._pack(self._forward(inp, i))
                host = torch.empty(packed.shape, dtype=packed.dtype,
                                   pin_memory=True)
                host.copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        return host, event

    @staticmethod
    def _pack(out) -> torch.Tensor:
        f32 = torch.float32
        return torch.cat([out.valid[..., None].to(f32),
                          out.coarse.mconf[..., None].to(f32),
                          out.mkpts0_f.to(f32), out.mkpts1_f.to(f32)], -1)

    @staticmethod
    def _finish(host, event) -> np.ndarray:
        """Wait for the result copy; the packed result as numpy (the
        devices' shards joined in row order)."""
        if isinstance(host, list):
            return np.concatenate([MatchingService._finish(h, e)
                                   for h, e in zip(host, event)])
        if event is not None:
            event.synchronize()
        return host.numpy()

    def _dispatch(self, inp, group: List[_Request], rung: int) -> None:
        """Bounded in-flight dispatch and bookkeeping."""
        self._inflight_sem.acquire()  # back-pressure: bounded in flight
        try:
            t0 = time.perf_counter()
            host, event = self._launch(inp)
            self.stats.record_phase("dispatch",
                                    (time.perf_counter() - t0) * 1e3)
        except Exception as e:  # a forward that raises fails its group
            self._inflight_sem.release()
            self._fail(group, e)
            return
        with self._inflight_cv:
            self._inflight.append((host, event, group))
            self._inflight_cv.notify_all()
        with self._lock, self.stats.lock:
            self.stats.batches += 1
            self.stats.padded_rows += rung - len(group)
            self.stats.batch_hist[len(group)] = \
                self.stats.batch_hist.get(len(group), 0) + 1

    def _dispatch_loop(self) -> None:
        """Pipelined mode: consume prepared batches in FIFO order."""
        while True:
            fut, group, rung = self._prepared.get()
            if fut is None:
                with self._inflight_cv:
                    self._inflight.append(None)  # completer shutdown
                    self._inflight_cv.notify_all()
                return
            try:
                inp = fut.result()
            except Exception as e:
                self._fail(group, e)
                continue
            self._dispatch(inp, group, rung)

    def _batch_loop(self) -> None:
        while True:
            item = self._take_group()
            if item is None:
                if self._stack_pool is not None:
                    self._prepared.put((None, None, None))
                else:
                    with self._inflight_cv:
                        self._inflight.append(None)  # completer shutdown
                        self._inflight_cv.notify_all()
                return
            b, group = item
            n = len(group)
            rung = next(r for r in self.batch_sizes if r >= n)
            if self._stack_pool is not None:
                # stacking and placement of this group run in the pool
                # while earlier groups dispatch and execute
                fut = self._stack_pool.submit(self._prepare, b, group, rung)
                self._prepared.put((fut, group, rung))
                continue
            try:
                inp = self._prepare(b, group, rung)
            except Exception as e:
                self._fail(group, e)
                continue
            self._dispatch(inp, group, rung)

    # ------------------------------------------------------ completer side
    def _complete_loop(self) -> None:
        while True:
            with self._inflight_cv:
                while not self._inflight:
                    self._inflight_cv.wait()
                item = self._inflight.popleft()
            if item is None:
                return
            host, event, group = item
            try:
                t0 = time.perf_counter()
                res = self._finish(host, event)
                self.stats.record_phase(
                    "fetch", (time.perf_counter() - t0) * 1e3)
            except Exception as e:
                self._inflight_sem.release()
                self._fail(group, e)
                continue
            self._inflight_sem.release()
            now = time.time()
            # stats before the futures resolve: a caller woken by
            # fut.result() must see this batch's latencies and busy count
            with self._lock, self.stats.lock:
                self.stats.requests += len(group)
                for r in group:
                    self.stats.latencies_ms.append(
                        (now - r.t_submit) * 1000.0)
                self._busy -= 1        # _group_done, lock already held
                self._lock.notify_all()
            for i, r in enumerate(group):
                valid, conf = res[i, :, 0] > 0.5, res[i, :, 1]
                keep = valid & (conf >= r.min_conf)
                _safe_resolve(r.future, {
                    "mkpts0": np.ascontiguousarray(res[i, keep, 2:4]),
                    "mkpts1": np.ascontiguousarray(res[i, keep, 4:6]),
                    "mconf": np.ascontiguousarray(conf[keep]),
                })
