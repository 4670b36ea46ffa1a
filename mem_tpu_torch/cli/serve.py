"""Batched event server on PyTorch: classification (``--surface cls``) and
DSEC semantic segmentation (``--surface seg``).

Port of mem_tpu/cli/serve.py: the same flags (plus ``--device``), the same
protocol and the same batching policy.

- Requests are bucketed into one static batch (``--batch_size``); the tail
  of a batch is wrap-padded with duplicates and the pad rows' outputs are
  dropped.
- A dispatcher collects requests until the bucket is full or
  ``--max_wait_ms`` expires; a fetcher thread waits for batch N's
  device->host copy while the device already runs batch N+1.
- ``/stats`` exports the autoscaling signal: queue_depth x batch_ms /
  batch_size is the latency queued work will add.

Protocol (stdlib HTTP, one round-trip per sample):
  POST /predict   body = the bytes of an ``.npy`` event file ((N, 4)
                  [x, y, t, p] rows, or an x/y/t/p structured array) ->
                  {"topk": [[class_idx, prob], ...], "queue_ms": float}
                  (cls), or a 440x640 8-bit PNG label map (seg)
  GET  /healthz   200 {"ok": true, "warm": true} once the forward is warm
  GET  /stats     queue depth, served/batches counters, avg batch fill,
                  EMA batch latency, added-latency estimate

The cls model is ``ft_vit`` from a ``.pth`` checkpoint in the reference
torch schema (``python -m mem_tpu.cli.export_torch`` writes one), or with
``--MAE 1`` the MAE-finetune classifier ``vit_base_patch16`` (global pool)
from a ``run_class_finetuning --MAE 1`` checkpoint; ``--use_ema 1`` serves
the checkpoint's EMA weights (``model_ema``, or the finetune CLI's ``ema``)
where it has them. The seg
model is EvBEiT + UPerNet from a ``.pth`` in the keys of
``utils.weights.seg_from_jax_params``. Preprocessing runs on the device
inside the forward (kernel K1; K4 on the DSEC canvas), attention through
kernel K2 (K3f at the seg backbone's 1025 tokens); the host only decodes,
crops, slices, sorts and assembles batches.

Usage:
  python -m mem_tpu_torch.cli.serve --checkpoint model.pth --nb_classes 101 \
      --dataset ncaltech101 --batch_size 8 --port 8787 [--device cuda]
  python -m mem_tpu_torch.cli.serve --surface seg --checkpoint seg.pth \
      --nb_classes 11 --slice_max_evs 180000 --batch_size 8 [--device cuda]
"""
from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mem_tpu_torch.cli.common import (add_preprocessing_args, build_classifier, build_preproc,
                                      detect_dataset)
from mem_tpu_torch.data.device_pipeline import preprocess_batch
from mem_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from mem_tpu_torch.utils.config import ConfigArgumentParser

# batch entries the eval preprocessing reads; the rest stay on the host
_DEVICE_KEYS = ("events", "n_valid", "sample_h", "sample_w")


def get_args(argv=None):
    p = ConfigArgumentParser("MEM classification serving (PyTorch)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help=".pth checkpoint ({'model': state_dict}) or a directory "
                        "(serves its newest .pth)")
    p.add_argument("--use_ema", type=int, default=0,
                   help="serve the EMA weights ('model_ema', or the finetune CLI's "
                        "'ema') when the checkpoint has them")
    p.add_argument("--nb_classes", "--num_classes", type=int, required=True)
    p.add_argument("--surface", type=str, default="cls", choices=("cls", "seg"),
                   help="cls = event classification (ft_vit); seg = DSEC semantic "
                        "segmentation (EvBEiT + UPerNet), PNG label-map responses")
    p.add_argument("--dataset", dest="data_path", type=str, default="ncaltech101",
                   help="cls dataset quirk profile (canvas/scale/extents): "
                        "ncaltech101 | ncars | nimagenet")
    p.add_argument("--seg_input_size", type=int, default=512)
    p.add_argument("--presort_y", type=int, default=1)
    # model geometry -- the finetune CLI's flag surface
    p.add_argument("--model", type=str, default="ft_vit")
    p.add_argument("--MAE", type=int, default=0,
                   help="1 = the MAE-finetune classifier (vit_base_patch16, global pool)")
    p.add_argument("--rel_pos_bias", type=int, default=1)
    p.add_argument("--abs_pos_emb", type=int, default=0)
    p.add_argument("--layer_scale_init_value", type=float, default=0.1)
    p.add_argument("--init_scale", type=float, default=0.001)
    p.add_argument("--use_mean_pooling", type=int, default=1)
    p.add_argument("--linear_probe_batch_norm", type=int, default=0)
    p.add_argument("--voxel", type=int, default=0)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--transformer_emb", type=int, default=768)
    p.add_argument("--transformer_depth", type=int, default=12)
    p.add_argument("--transformer_heads", type=int, default=12)
    p.add_argument("--transformer_mlp_ratio", type=float, default=4.0)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--drop_path", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--int8", type=int, default=0,
                   help="W8A8 int8 products (fc1, qkv, proj) in the trunk's forward, "
                        "both surfaces (ops/quant.py)")
    add_preprocessing_args(p)
    p.set_defaults(normalize_events=1)
    # serving knobs
    p.add_argument("--port", type=int, default=8787,
                   help="0 = ephemeral (printed + returned on build)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--batch_size", type=int, default=8,
                   help="the static batch bucket (8 for latency SLOs, 64 for "
                        "throughput)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batching deadline once a request is pending")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and preprocessing: cuda "
                        "(the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


class _Request:
    __slots__ = ("events", "done", "result", "error", "t_enq")

    def __init__(self, events):
        self.events = events
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.t_enq = time.monotonic()


class ServeState:
    """Queue + dispatcher + stats shared between the HTTP threads and the
    one device thread (one forward in flight to the device at a time;
    replicas scale by process)."""

    def __init__(self, args, infer, assemble, unpack):
        self.args = args
        self.infer = infer
        self.assemble = assemble
        self.unpack = unpack
        self.queue: deque = deque()
        self.cv = threading.Condition()
        self.stop = False
        self.warm = False
        self.served = 0
        self.batches = 0
        self.fill_sum = 0
        self.batch_ms_ema = 0.0
        # dispatch/fetch pipeline: CUDA launches are asynchronous, so the
        # fetcher blocks on batch N's device->host copy while the device
        # already runs batch N+1 (depth 2 = double buffering)
        self.inflight: deque = deque()
        self.fetch_cv = threading.Condition()
        self.max_inflight = 2

    # -- dispatcher ---------------------------------------------------------
    def run(self):
        B = self.args.batch_size
        wait_s = self.args.max_wait_ms / 1e3
        while True:
            with self.cv:
                while not self.queue and not self.stop:
                    self.cv.wait(0.05)
                if self.stop:
                    for r in self.queue:
                        r.error = "server shutting down"
                        r.done.set()
                    self.queue.clear()
                    break
                reqs = [self.queue.popleft()]
                deadline = time.monotonic() + wait_s
                while len(reqs) < B:
                    if self.queue:
                        reqs.append(self.queue.popleft())
                        continue
                    rem = deadline - time.monotonic()
                    if rem <= 0 or self.stop:
                        break
                    self.cv.wait(min(rem, 0.005))
            self._dispatch_batch(reqs)
        with self.fetch_cv:
            self.fetch_cv.notify_all()

    def _dispatch_batch(self, reqs):
        B = self.args.batch_size
        with self.fetch_cv:
            while len(self.inflight) >= self.max_inflight:
                self.fetch_cv.wait(0.05)
        try:
            batch = self.assemble([r.events for r in reqs], B)
            t0 = time.perf_counter()
            outputs = self.infer(batch)     # asynchronous on the device
        except Exception as e:  # bad payload shapes surface per request
            for r in reqs:
                r.error = f"inference failed: {e!r}"
                r.done.set()
            return
        with self.fetch_cv:
            self.inflight.append((reqs, outputs, t0))
            self.fetch_cv.notify_all()

    # -- fetcher -------------------------------------------------------------
    def run_fetch(self):
        while True:
            with self.fetch_cv:
                while not self.inflight and not self.stop:
                    self.fetch_cv.wait(0.05)
                if not self.inflight and self.stop:
                    return
                reqs, outputs, t0 = self.inflight.popleft()
                self.fetch_cv.notify_all()
            try:
                outputs = fetch(outputs)
            except Exception as e:
                for r in reqs:
                    r.error = f"inference failed: {e!r}"
                    r.done.set()
                continue
            ms = (time.perf_counter() - t0) * 1e3
            with self.cv:
                self.batches += 1
                self.fill_sum += len(reqs)
                self.batch_ms_ema = (ms if self.batches == 1
                                     else 0.9 * self.batch_ms_ema + 0.1 * ms)
                self.served += len(reqs)
            for j, r in enumerate(reqs):
                qms = round((time.monotonic() - r.t_enq) * 1e3, 3)
                r.result = self.unpack(j, outputs, qms)   # (ctype, bytes)
                r.done.set()

    # -- stats --------------------------------------------------------------
    def stats(self):
        with self.cv:
            depth = len(self.queue)
            bm = self.batch_ms_ema
            return {
                "queue_depth": depth,
                "batch_ms_ema": round(bm, 3),
                "added_latency_ms": round(
                    depth * bm / max(self.args.batch_size, 1), 3),
                "served": self.served,
                "batches": self.batches,
                "avg_fill": round(self.fill_sum / self.batches, 3)
                            if self.batches else 0.0,
                "batch_size": self.args.batch_size,
                "warm": self.warm,
            }


def fetch(outputs):
    """Wait for an ``infer`` result: (tensors copied to the host, the CUDA
    event recorded after the copies, or None on the CPU) -> numpy arrays."""
    host, done = outputs
    if done is not None:
        done.synchronize()
    return tuple(t.numpy() for t in host)


def _decode_events(body: bytes):
    """-> (events (N, 4) float64, p_signed). Structured x/y/t/p payloads are
    polarity-normalized to +-1 here and tagged p_signed=True; plain (N, 4)
    arrays pass through with their on-disk polarity convention."""
    arr = np.load(io.BytesIO(body), allow_pickle=False)
    if arr.dtype.fields is not None and "x" in arr.dtype.fields:
        ev = np.empty((arr.shape[0], 4), np.float64)
        ev[:, 0] = arr["x"]
        ev[:, 1] = arr["y"]
        ev[:, 2] = arr["t"]
        ev[:, 3] = arr["p"].astype(np.int8) * 2 - 1
        return ev, True
    ev = np.asarray(arr, np.float64)
    if ev.ndim != 2 or ev.shape[1] != 4:
        ev = ev.reshape(-1, 4)
    return ev, False


def _load_payload(args):
    # bind the scan result once: the directory may gain a newer file between
    # two scans
    path = latest_checkpoint(args.checkpoint) or args.checkpoint
    return path, load_checkpoint(path)


def classify(model, pp, batch: dict, k: int):
    """The served forward on a device batch: eval preprocessing, the model,
    softmax, top-k -> (probabilities, class indices), each (B, k)."""
    images = preprocess_batch(batch, pp, is_train=False)
    probs = torch.softmax(model(images).float(), dim=-1)
    return torch.topk(probs, k, dim=-1)


def make_assemble(args, pp):
    """The host-side batch assembly of the cls surface: decode results ->
    a static (B, slice_max_evs, 4) f32 batch, the tail wrap-padded, long
    streams sliced to a window, per-sample extents from the data (fixed for
    N-ImageNet, whose f32 wire ships host-scaled coordinates)."""
    ds = detect_dataset(args.data_path)
    scale_xy = ((args.input_W / 640.0, args.input_H / 480.0)
                if ds == "nimagenet" else None)
    fixed_hw = (args.input_H, args.input_W) if ds == "nimagenet" else None
    cap = args.slice_max_evs

    def assemble(events_list, B):
        n = len(events_list)
        ev = np.zeros((B, cap, 4), np.float32)
        nv = np.zeros((B,), np.int32)
        sh = np.zeros((B,), np.int32)
        sw = np.zeros((B,), np.int32)
        rng = np.random.default_rng(0)  # eval slice: any window is valid
        for j in range(B):
            e, _ = events_list[j % n]   # wrap-pad the tail
            if scale_xy is not None:
                e = e.copy()
                e[:, 0] *= scale_xy[0]
                e[:, 1] *= scale_xy[1]
            m = e.shape[0]
            if m > cap:
                start = int(rng.integers(0, m - cap + 1))
                e = e[start:start + cap]
                m = cap
            ev[j, :m] = e
            nv[j] = m
            if fixed_hw is not None:
                sh[j], sw[j] = fixed_hw
            elif m > 0:
                sw[j] = min(int(e[:, 0].max()) + 1, pp.canvas_w)
                sh[j] = min(int(e[:, 1].max()) + 1, pp.canvas_h)
            else:
                sh[j], sw[j] = pp.canvas_h, pp.canvas_w
        return {
            "events": ev, "n_valid": nv,
            "label": np.zeros((B,), np.int64),
            "sample_h": sh, "sample_w": sw,
            "time_flip": np.zeros(B, bool), "x_flip": np.zeros(B, bool),
            "shift_xy": np.zeros((B, 2), np.int32),
            "aug_seed": np.zeros(B, np.uint32),
        }

    return assemble


def to_device(batch: dict, device) -> dict:
    """The batch entries the eval forward reads, as tensors on ``device``."""
    return {n: torch.from_numpy(batch[n]).to(device, non_blocking=True)
            for n in _DEVICE_KEYS}


def _build_cls(args, dtype, device):
    """Classification surface: ft_vit (or, with ``--MAE 1``, the MAE
    classifier) + the eval preprocessing of the finetune CLI. Returns
    (assemble, infer, unpack)."""
    if detect_dataset(args.data_path) == "dsec":
        raise SystemExit("serve: --surface cls does not cover DSEC "
                         "(use --surface seg)")
    pp = build_preproc(args, is_train=False)
    assemble = make_assemble(args, pp)
    model = build_classifier(args, args.nb_classes, dtype, device)
    path, payload = _load_payload(args)
    key = next((k for k in ("model_ema", "ema") if args.use_ema and k in payload), "model")
    if args.use_ema and key == "model":
        print("note: checkpoint has no EMA state; serving raw params")
    # the weights move to the device once, at load; an EMA of the parameters
    # alone takes the buffers from the raw state_dict
    weights = payload[key] if key == "model" else {**payload["model"], **payload[key]}
    model.load_state_dict(weights, strict=True)
    model.eval()
    print(f"serving {key} from {path} on {device}")
    k = args.topk

    def infer(batch):
        with torch.inference_mode():
            probs, idxs = classify(model, pp, to_device(batch, device), k)
            host = (probs.to("cpu", non_blocking=True), idxs.to("cpu", non_blocking=True))
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done

    def unpack(j, outputs, queue_ms):
        probs, idxs = outputs
        body = json.dumps({
            "topk": [[int(c), float(p)] for c, p in zip(idxs[j], probs[j])],
            "queue_ms": queue_ms,
        }).encode()
        return "application/json", body

    return assemble, infer, unpack


def make_seg_assemble(cap: int, presort: bool):
    """The host-side batch assembly of the seg surface: dsec loader
    semantics (dataset_folder.py:275-283 + the seg pipeline's crop on the
    f32-rounded y): p {0, 1} -> +-1 unless the payload arrived signed, y in
    [0, 440), a window of ``cap`` events, the stable y presort, the tail
    wrap-padded. No "label" entry: serving reads only the images."""
    from mem_tpu_torch.data.seg_pipeline import SEG_H

    def assemble(events_list, B):
        n = len(events_list)
        ev = np.zeros((B, cap, 4), np.float32)
        nv = np.zeros((B,), np.int32)
        rng = np.random.default_rng(0)
        for j in range(B):
            e, p_signed = events_list[j % n]
            y32 = e[:, 1].astype(np.float32)
            e = e[(y32 >= 0) & (y32 < SEG_H)].astype(np.float32)
            if not p_signed:
                e[:, 3] = 2 * e[:, 3] - 1
            m = e.shape[0]
            if m > cap:
                start = int(rng.integers(0, m - cap + 1))
                e = e[start:start + cap]
                m = cap
            if presort and m:
                e = e[np.argsort(e[:, 1], kind="stable")]
            ev[j, :m] = e
            nv[j] = m
        return {"events": ev, "n_valid": nv}

    return assemble


def _build_seg(args, dtype, device):
    """Segmentation surface: EvBEiT + UPerNet from a segmentor .pth;
    single-scale whole-image inference (TTA is an offline-eval feature).
    Responses are 440x640 PNG label maps. Returns (assemble, infer,
    unpack)."""
    from mem_tpu_torch.data.seg_pipeline import seg_preprocess_batch
    from mem_tpu_torch.models.segmentation import build_segmentor

    model = build_segmentor(args.nb_classes, args.seg_input_size, args.transformer_emb,
                            args.transformer_depth, args.transformer_heads, dtype, device)
    path, payload = _load_payload(args)
    # the weights move to the device once, at load
    model.load_state_dict(payload["model"], strict=True)
    model.eval()
    print(f"serving seg params from {path} on {device}")
    presort = bool(args.presort_y)

    def infer(batch):
        with torch.inference_mode():
            dev_batch = {n: torch.from_numpy(batch[n]).to(device, non_blocking=True)
                         for n in ("events", "n_valid")}
            images, _ = seg_preprocess_batch(dev_batch, False, y_sorted=presort)
            logits, _ = model(images)
            host = (logits.float().argmax(dim=-1).to(torch.uint8).to("cpu", non_blocking=True),)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done

    def unpack(j, outputs, queue_ms):
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(outputs[0][j]).save(buf, format="PNG")
        return "image/png", buf.getvalue()

    return make_seg_assemble(args.slice_max_evs, presort), infer, unpack


def _int8_forwards(infer):
    """``infer`` with ``models.vit.INT8_GEMM`` set around each forward (the
    reference sets it for the process, serve.py:457-460): W8A8 fc1 / qkv /
    proj in the eval-mode trunk, both surfaces."""
    from mem_tpu_torch.models import vit

    def run(batch):
        with vit.int8_gemm():
            return infer(batch)

    return run


def build_server(args):
    """Construct (httpd, state, threads); main() runs it, tests drive it
    programmatically. The kernels are built and the forward is warmed
    before this returns, so /healthz is green from the first request."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    build = _build_seg if args.surface == "seg" else _build_cls
    assemble, infer, unpack = build(args, dtype, device)
    if args.int8:
        infer = _int8_forwards(infer)

    state = ServeState(args, infer, assemble, unpack)
    warm = np.zeros((8, 4), np.float64)
    warm[:, :2] = 1.0
    fetch(infer(assemble([(warm, False)], args.batch_size)))
    state.warm = True

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "warm": state.warm})
            elif self.path == "/stats":
                self._json(200, state.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = _Request(_decode_events(self.rfile.read(n)))
            except Exception as e:
                self._json(400, {"error": f"bad event payload: {e!r}"})
                return
            with state.cv:
                state.queue.append(req)
                state.cv.notify_all()
            req.done.wait()
            if req.error:
                self._json(500, {"error": req.error})
                return
            ctype, body = req.result
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Queue-Ms", str(
                round((time.monotonic() - req.t_enq) * 1e3, 3)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer((args.host, args.port), Handler)
    threads = (
        threading.Thread(target=state.run, name="dispatcher", daemon=True),
        threading.Thread(target=state.run_fetch, name="fetcher", daemon=True),
    )
    for t in threads:
        t.start()
    return httpd, state, threads


def main(argv=None):
    args = get_args(argv)
    httpd, state, threads = build_server(args)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(B={args.batch_size}, max_wait={args.max_wait_ms}ms, "
          f"topk={args.topk}, device={args.device})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        with state.cv:
            state.stop = True
            state.cv.notify_all()
        for t in threads:
            t.join(timeout=5)
        httpd.server_close()


if __name__ == "__main__":
    main()
