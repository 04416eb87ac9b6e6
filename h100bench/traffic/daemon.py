"""The TCP daemon: ``engines/fast.py::serve_loop`` (dynamic batching) behind
``engines/netserve.py::serve_over_tcp``, the objects that ``fast_st serve
--tcp`` builds, in the run's own process, under open-loop load from
``loadgen.py`` in a process of its own.

Set-up writes ``count`` seeded PNGs (smooth fields, so that decode and
encode cost what a photograph's do), starts the daemon on a free loopback
port with the seeded parameters, and lets the generator connect and send
``warm`` requests. Mix parameters: ``batch``, ``rate`` (requests per
second, fixed at about four fifths of the highest rate the daemon sustains),
``connections``, ``count``, ``slots`` (output names reused in turn, so that
a run writes a bounded set of files, every one of which the check reads),
``warm``, ``traced_share`` (the part of the window profiled in
a traced run, after its ``STATS``).

``serve_p95_ms`` is the 95th percentile, over every request due in the
window, of the time from when it was due to its answer; a request that
failed or never came counts as slower than every other.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from h100bench import harness, inputs, program
from h100bench import trace as trace_lib
from h100bench.reference import nets

UNITS = {"serve_p95_ms": "ms"}
GENERATOR_WAIT_S = 300.0
# In a traced run the daemon answers STATS at this share of the window, and
# the profiler then covers ``traced_share`` of it: the profiler slows the
# daemon's host threads, and the queue it builds would reach the answer.
STATS_AT = 0.6
BLOCK = 64  # answers the reference checks at a time


def p95(values) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]


class _Handshake:
    """The daemon's stdout: on its ``TCP <host> <port>`` line, start the
    load generator (``start(port)``)."""

    def __init__(self, start):
        self.start, self.started = start, False

    def write(self, s: str) -> int:
        for line in s.splitlines():
            if line.startswith("TCP ") and not self.started:
                self.started = True
                self.start(int(line.split()[2]))
        return len(s)

    def flush(self) -> None:
        pass


def run(run: harness.Run) -> harness.Outcome:
    import torch
    from PIL import Image
    from styletransfer_tpu_torch.engines import fast, netserve

    t, cfg, dev = run.traffic, run.config, run.device
    side = cfg["image_side"]
    w = inputs.transformnet_weights(run.seed, dev)
    params = program.transformnet(w)
    images = inputs.images(t["count"], side, inputs.generator(dev, run.seed, inputs.IMAGES),
                           dev).cpu().numpy()
    in_dir, out_dir = (os.path.join(run.workdir, d) for d in ("in", "out"))
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    for i, img in enumerate(images):
        Image.fromarray(img).save(os.path.join(in_dir, f"{i}.png"))
    result_path = os.path.join(run.workdir, "load.json")
    procs, watchers, layer = [], [], {}

    def start_generator(port: int) -> None:
        cmd = [sys.executable, "-m", "h100bench.loadgen", "--port", str(port),
               "--seed", str(run.seed), "--rate", repr(float(t["rate"])),
               "--seconds", repr(float(run.seconds)), "--connections", str(t["connections"]),
               "--inputs", in_dir, "--count", str(t["count"]), "--outputs", out_dir,
               "--slots", str(t["slots"]), "--warm", str(t["warm"]),
               "--stats-at", repr(STATS_AT if run.trace else 1.0), "--result", result_path]
        proc = subprocess.Popen(cmd, cwd=os.path.dirname(harness.HERE), stdout=subprocess.PIPE,
                                text=True)
        procs.append(proc)
        watchers.append(threading.Thread(target=watch, args=(proc,), daemon=True))
        watchers[-1].start()

    def watch(proc) -> None:
        """Read the generator's WINDOW line; in a traced run profile the
        middle ``traced_share`` of the window."""
        for line in proc.stdout:
            if not line.startswith("WINDOW "):
                continue
            start = float(line.split()[1])
            if run.trace:
                lead = run.seconds * (STATS_AT + 0.05)
                time.sleep(max(0.0, start + lead - time.monotonic()))
                tr = trace_lib.Trace()
                with trace_lib.traced(dev, tr, host=False, defer=True):
                    time.sleep(run.seconds * t["traced_share"])
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                layer["trace"] = tr

    def run_loop(stdin, stdout):
        return fast.serve_loop("h100bench", out_dir=out_dir, params=params,
                               precision=cfg["precision"], pad_mode="reflect",
                               batch_size=t["batch"], sizes=[side], stdin=stdin,
                               stdout=stdout, device=dev)

    try:
        netserve.serve_over_tcp(run_loop, host="127.0.0.1", port=0,
                                stdout=_Handshake(start_generator), name="h100bench-tcp")
    finally:
        for proc in procs:
            try:
                proc.wait(timeout=GENERATOR_WAIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for th in watchers:
            th.join(timeout=GENERATOR_WAIT_S)
    if not procs or procs[0].returncode != 0:
        raise RuntimeError("the load generator failed")
    if "trace" in layer:
        layer["trace"].read()
    with open(result_path) as f:
        load = json.load(f)
    run.window_starts(load["start"])
    requests = load["requests"]
    failed = sum(not r.get("ok") for r in requests)
    latency = [(r["done"] - r["due"]) * 1e3 if r.get("ok") else float("inf") for r in requests]
    late = [(r["sent"] - r["due"]) * 1e3 for r in requests]
    done = [r for r in requests if r.get("ok")]
    span = max(r["done"] for r in done) - load["start"] if done else float("nan")
    quarter = max(1, len(latency) // 4)
    print(f"h100bench: {len(requests)} requests at {t['rate']}/s, {failed} failed; latency "
          f"p50 {sorted(latency)[len(latency) // 2]:.2f} ms, p95 {p95(latency):.2f} ms, "
          f"first and last quarter's p50 {sorted(latency[:quarter])[quarter // 2]:.2f} / "
          f"{sorted(latency[-quarter:])[quarter // 2]:.2f} ms; completed "
          f"{len(done) / span:.2f}/s; generator late p95 {p95(late):.3f} ms, max "
          f"{max(late):.3f} ms; warm answers {load['warm_ok']}/{t['warm']}; {load['stats']}",
          file=sys.stderr, flush=True)
    stats = dict(kv.split("=", 1) for kv in (load["stats"] or "").split() if "=" in kv)
    if "p95_ms" in stats:
        layer["stats_p95_ms"] = float(stats["p95_ms"])
    e2e = {} if run.trace else {"serve_p95_ms": p95(latency)}

    # The answers checked: every request that wrote its output slot last
    # (their files are still there).
    last = {}
    for k, r in enumerate(requests):
        if r.get("ok"):
            last[r["slot"]] = k
    samples = [(requests[k]["input"], os.path.join(out_dir, f"{requests[k]['slot']}.png"))
               for k in sorted(last.values())]
    outputs = []
    for _, path in samples:
        with Image.open(path) as img:
            outputs.append(np.asarray(img.convert("RGB")))
    ins = [i for i, _ in samples]
    del params

    def verify():
        worst, gaps = 0.0, []
        with nets.precision(tf32=False):
            for i in range(0, len(ins), BLOCK):
                ref = nets.transformnet_levels(w, torch.from_numpy(images[ins[i:i + BLOCK]])
                                               .to(dev))
                out = torch.from_numpy(np.stack(outputs[i:i + BLOCK])).to(dev).float()
                worst = max(worst, float((out - ref).abs().max()))
                gaps.append((out - torch.round(ref)).abs().flatten())
        return {"excess_levels": worst - 0.5, "mean_levels": float(torch.cat(gaps).mean()),
                "failed_answers": failed}

    return harness.Outcome(attempted=len(requests), failed=failed, end_to_end=e2e, verify=verify, layer=layer)
