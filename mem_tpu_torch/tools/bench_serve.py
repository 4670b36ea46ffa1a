"""Load generator for ``python -m mem_tpu_torch.cli.serve``: the end-to-end
serving operating point (HTTP, the host's batch assembly and the card's
forward), beside ``tools.trace_infer``'s device-only numbers.

Port of scripts/bench_serve.py, copied: stdlib and numpy only, no torch, so
that it runs beside the server process without touching the card. From the
repo root, with the server listening::

    python -m mem_tpu_torch.tools.bench_serve url=http://127.0.0.1:8787 \
        conc=16 secs=20 n_events=30000 [h=180 w=240]

It posts ``conc`` clients' worth of requests (a pool of 32 distinct .npy
payloads of ``n_events`` events on an h x w sensor from
``np.random.default_rng(0)``) for ``secs`` seconds once /healthz reports a
warm server, and prints one JSON line: requests, errors, wall seconds,
throughput, latency p50 / p95 / p99 and the server's /stats.
"""
import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np


def main(argv=None):
    kv = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    url = kv.get("url", "http://127.0.0.1:8787")
    conc = int(kv.get("conc", 16))
    secs = float(kv.get("secs", 20))
    n = int(kv.get("n_events", 30000))
    h, w = int(kv.get("h", 180)), int(kv.get("w", 240))

    rng = np.random.default_rng(0)
    # pre-serialize a pool of distinct payloads (fresh bytes per request
    # would bottleneck the 1-core loadgen, identical bytes risk dedup
    # anywhere in the stack)
    pool = []
    for _ in range(32):
        ev = np.zeros((n, 4), np.float64)
        ev[:, 0] = rng.integers(0, w, n)
        ev[:, 1] = rng.integers(0, h, n)
        ev[:, 2] = np.sort(rng.integers(0, 10**6, n))
        ev[:, 3] = rng.choice([-1.0, 1.0], n)
        b = io.BytesIO()
        np.save(b, ev)
        pool.append(b.getvalue())

    # wait for warm health
    for _ in range(600):
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                if json.loads(r.read()).get("warm"):
                    break
        except Exception:
            pass
        time.sleep(1)
    else:
        raise SystemExit("server never became healthy")

    stop = time.monotonic() + secs
    lat, errors = [], [0]
    lock = threading.Lock()

    def worker(i):
        k = i
        while time.monotonic() < stop:
            body = pool[k % len(pool)]
            k += conc
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(url + "/predict", data=body,
                                             method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    r.read()
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    lat.append(ms)
            except Exception:
                with lock:
                    errors[0] += 1

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(conc)]
    t_start = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.monotonic() - t_start

    with urllib.request.urlopen(url + "/stats", timeout=10) as r:
        stats = json.loads(r.read())
    a = np.asarray(sorted(lat))
    out = {
        "requests": len(lat),
        "errors": errors[0],
        "wall_s": round(wall, 2),
        "throughput_rps": round(len(lat) / wall, 1),
        "p50_ms": round(float(a[len(a) // 2]), 2) if len(a) else None,
        "p95_ms": round(float(a[int(len(a) * 0.95)]), 2) if len(a) else None,
        "p99_ms": round(float(a[int(len(a) * 0.99)]), 2) if len(a) else None,
        "concurrency": conc,
        "stats": stats,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
