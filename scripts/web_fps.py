"""Measure the /monitor MJPEG frame rate of a running web app.

Usage: python scripts/web_fps.py <base_url> <enable_path> <seconds>

Connects, enables the requested backend, then reads the multipart
stream counting JPEG parts over the window; prints one JSON line.
The first frame after enabling is excluded from the window (it carries
backend warmup/compile, which /metrics reports separately).
"""
import json
import sys
import time
import urllib.request


def _metrics(base):
    return json.loads(urllib.request.urlopen(
        base + "/metrics", timeout=30).read())


def main():
    base, enable, seconds = sys.argv[1], sys.argv[2], float(sys.argv[3])
    urllib.request.urlopen(base + "/", timeout=30).read()
    urllib.request.urlopen(base + enable, timeout=900).read()
    resp = urllib.request.urlopen(base + "/monitor", timeout=900)
    # first frame = warmup (queue fill / first batch through the device)
    boundary = b"--frame"
    buf = b""
    frames = -1
    t0 = None
    deadline = None
    m0 = None
    while deadline is None or time.time() < deadline:
        chunk = resp.read(65536)
        if not chunk:
            break
        buf += chunk
        while boundary in buf:
            _, buf = buf.split(boundary, 1)
            frames += 1
            if frames == 0:
                t0 = time.time()
                deadline = t0 + seconds
                m0 = _metrics(base)
    elapsed = time.time() - t0 if t0 else 0.0
    m1 = _metrics(base)
    out = {
        "enable": enable,
        "mjpeg_frames": frames,
        "seconds": round(elapsed, 2),
        "mjpeg_fps": round(frames / elapsed, 2) if elapsed else None,
        "overlay_errors": m1.get("overlay_errors"),
    }
    f0, f1 = m0.get("fused") if m0 else None, m1.get("fused")
    if f0 and f1 and elapsed:
        # the fused stage's OWN sustained rate (composites produced),
        # independent of the MJPEG latest-frame sampling
        out["fused_stage_fps"] = round(
            (f1["frames"] - f0["frames"]) / elapsed, 2)
        out["fused_phase_p50_ms"] = f1.get("phase_p50_ms")
        out["fused_latency_p50_ms"] = f1.get("latency_p50_ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
