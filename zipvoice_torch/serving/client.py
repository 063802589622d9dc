"""Benchmark client for the TTS server of ``serving/server.py``
(counterpart of ``zipvoice_tpu/serving/client.py``): a concurrency sweep
with latency percentiles and the server's own phase split, over its
HTTP/JSON protocol.  It needs numpy and the standard library only.

  python -m zipvoice_torch.serving.client --url http://localhost:8000 \\
    --prompt-wav prompt.wav --prompt-text "..." \\
    --text "hello" --concurrency 1,2,4,8 --num-requests 32 [--use-cache] \\
    [--num-speakers 4] [--text-file texts.txt]

``--text-file`` holds one text per line, cycled across requests.
"""

import argparse
import base64
import io
import json
import logging
import threading
import time
import urllib.request
import wave
from typing import List

import numpy as np


def post(url: str, path: str, obj: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        url + path,
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def prompt_prefixes(path: str, n: int) -> List[bytes]:
    """``n`` wav files (as bytes) of prefixes of the wav at ``path``: 100%,
    88%, 76%, 64%, 52% of it, then again, and never under half a second.
    Distinct speakers from one wav, whose prompt lengths differ, so that a
    micro-batch of several of them holds rows of several prompt lengths."""
    with wave.open(path, "rb") as f:
        sr, nch, sw = f.getframerate(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(f.getnframes())
    n_total = len(raw) // (nch * sw)
    out = []
    for i in range(n):
        frac = 1.0 - 0.12 * (i % 5)
        m = max(int(n_total * frac), sr // 2)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as g:
            g.setnchannels(nch)
            g.setsampwidth(sw)
            g.setframerate(sr)
            g.writeframes(raw[: m * nch * sw])
        out.append(buf.getvalue())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--url", type=str, default="http://localhost:8000")
    p.add_argument("--prompt-wav", type=str, required=True)
    p.add_argument("--prompt-text", type=str, required=True)
    p.add_argument("--text", type=str, default=None)
    p.add_argument("--text-file", type=str, default=None,
                   help="file with one text per line, cycled across "
                        "requests")
    p.add_argument("--concurrency", type=str, default="1,2,4,8")
    p.add_argument("--num-requests", type=int, default=32)
    p.add_argument("--use-cache", action="store_true",
                   help="register the speaker once and reuse it")
    p.add_argument("--num-speakers", type=int, default=1,
                   help="register N distinct speakers (prefixes of the "
                        "prompt of different lengths) and send requests "
                        "to them in turn: traffic of several speakers, "
                        "which the server batches together; implies "
                        "--use-cache")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not (args.text or args.text_file):
        p.error("pass --text or --text-file")
    if args.text:
        texts = [args.text]
    else:
        with open(args.text_file, encoding="utf-8") as f:
            texts = [ln.strip() for ln in f if ln.strip()]

    with open(args.prompt_wav, "rb") as f:
        wav_b64 = base64.b64encode(f.read()).decode()

    if args.num_speakers > 1:
        names = []
        for i, data in enumerate(prompt_prefixes(args.prompt_wav,
                                                 args.num_speakers)):
            name = f"bench{i}"
            post(args.url, "/speaker", {
                "name": name,
                "prompt_text": args.prompt_text,
                "prompt_wav_b64": base64.b64encode(data).decode(),
            })
            names.append(name)

        def payload_for(text, rid=0):
            return {"speaker": names[rid % len(names)], "text": text}
    elif args.use_cache:
        post(args.url, "/speaker", {
            "name": "bench",
            "prompt_text": args.prompt_text,
            "prompt_wav_b64": wav_b64,
        })

        def payload_for(text, rid=0):
            return {"speaker": "bench", "text": text}
    else:
        def payload_for(text, rid=0):
            return {
                "text": text,
                "prompt_text": args.prompt_text,
                "prompt_wav_b64": wav_b64,
            }

    # first touch of every registered speaker, untimed
    for i in range(max(args.num_speakers, 1)):
        post(args.url, "/tts", payload_for(texts[i % len(texts)], i))

    for conc in map(int, args.concurrency.split(",")):
        latencies = []
        audio_s = []
        phases: dict = {}
        lock = threading.Lock()
        n_per = args.num_requests // conc

        def worker(wid):
            for j in range(n_per):
                rid = wid + j * conc
                text = texts[rid % len(texts)]
                t0 = time.perf_counter()
                out = post(args.url, "/tts", payload_for(text, rid))
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)
                    audio_s.append(out["audio_s"])
                    for k, v in (out.get("timing") or {}).items():
                        phases.setdefault(k, []).append(v)

        t_start = time.perf_counter()
        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(conc)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = time.perf_counter() - t_start
        lat = np.array(latencies) * 1000
        logging.info(
            f"concurrency {conc}: {len(lat)} requests, total {total:.3f}s, "
            f"P50 {np.percentile(lat, 50):.2f}ms "
            f"P90 {np.percentile(lat, 90):.2f}ms "
            f"P99 {np.percentile(lat, 99):.2f}ms avg {lat.mean():.2f}ms, "
            f"audio-s/s {sum(audio_s) / total:.2f}"
        )
        if phases:
            # the server's phase split (P50/P90 each), to tell queueing
            # from compute in the tail
            parts = []
            for k in ("tokenize_ms", "queue_ms", "sample_ms", "vocode_ms"):
                if k in phases:
                    a = np.array(phases[k])
                    parts.append(
                        f"{k.removesuffix('_ms')} "
                        f"{np.percentile(a, 50):.1f}/"
                        f"{np.percentile(a, 90):.1f}"
                    )
            logging.info("  server phases P50/P90 ms: " + "  ".join(parts))


if __name__ == "__main__":
    main()
