"""gRPC benchmark client: concurrency sweep with latency percentiles + TTFB
(the port's counterpart of ``zipvoice_tpu/serving/client_grpc.py``).

Counterpart of the reference's Triton gRPC bench harness
(reference runtime/nvidia_triton/client_grpc.py): registers a speaker,
sweeps request concurrency against the unary Synthesize method, and
measures the streaming method's time-to-first-audio.  Emits one JSON line
per sweep point:
  {"concurrency": c, "n": n, "p50": s, "p90": s, "p99": s,
   "audio_s_per_s": x, ["ttfb_p50": s]}

Every percentile is ``np.percentile``'s (linear between the two nearest
samples), as ``serving/client.py`` reads them.  It needs numpy and grpc
only.

  python -m zipvoice_torch.serving.client_grpc --target localhost:50051 \\
      --prompt-wav p.wav --prompt-text "..." [--stream] \\
      [--concurrency 1,2,4,8] [--n 16]
"""

import argparse
import base64
import concurrent.futures as cf
import json
import time

import numpy as np

SERVICE = "zipvoice.TTS"

_TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank.",
    "Machine learning systems convert text into natural sounding speech.",
    "A long time ago in a galaxy far away, stories were told by firelight.",
    "Please confirm your reservation for two people at seven o'clock.",
]


def _ident(b):
    return b


def _channel_methods(channel):
    unary = lambda m: channel.unary_unary(  # noqa: E731
        f"/{SERVICE}/{m}", request_serializer=_ident,
        response_deserializer=_ident,
    )
    stream = channel.unary_stream(
        f"/{SERVICE}/SynthesizeStream", request_serializer=_ident,
        response_deserializer=_ident,
    )
    return unary("RegisterSpeaker"), unary("Synthesize"), stream


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` (seconds), rounded to the
    millisecond as the printed points are."""
    return round(float(np.percentile(values, q)), 3)


def sweep_point(concurrency: int, latencies, audio_s: float,
                wall: float) -> dict:
    """One sweep point from its requests' latencies and seconds of audio
    over the sweep's wall time."""
    return {
        "concurrency": concurrency, "n": len(latencies),
        "p50": percentile(latencies, 50), "p90": percentile(latencies, 90),
        "p99": percentile(latencies, 99),
        "audio_s_per_s": round(audio_s / wall, 2),
    }


def _stream_times(syn_stream, speaker: str, text, n: int):
    """(time to the first chunk, time to the last) of ``n`` streamed
    requests, one at a time."""
    ttfbs, totals = [], []
    for i in range(n):
        req = json.dumps({
            "speaker": speaker, "text": text or _TEXTS[i % len(_TEXTS)],
        }).encode()
        t0 = time.perf_counter()
        it = syn_stream(req)
        next(iter(it))
        ttfbs.append(time.perf_counter() - t0)
        for _ in it:  # drain
            pass
        totals.append(time.perf_counter() - t0)
    return ttfbs, totals


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--target", type=str, default="localhost:50051")
    p.add_argument("--prompt-wav", type=str, required=True)
    p.add_argument("--prompt-text", type=str, required=True)
    p.add_argument("--speaker", type=str, default="bench")
    p.add_argument("--concurrency", type=str, default="1,2,4,8")
    p.add_argument("--n", type=int, default=16,
                   help="requests per sweep point")
    p.add_argument("--ttfb-text", type=str, default=None,
                   help="long multi-chunk text for the streaming TTFB "
                        "measurement (shows ttfb << total)")
    p.add_argument("--stream", action="store_true",
                   help="also measure streaming TTFB at concurrency 1")
    p.add_argument("--stream-under-load", type=int, default=0,
                   help="measure streaming TTFB while N unary workers "
                        "keep the server loaded (the decoupled-mode "
                        "latency question: does first audio stay "
                        "responsive under traffic)")
    args = p.parse_args(argv)

    import grpc

    channel = grpc.insecure_channel(args.target)
    register, synthesize, syn_stream = _channel_methods(channel)

    with open(args.prompt_wav, "rb") as f:
        wav_b64 = base64.b64encode(f.read()).decode()
    register(json.dumps({
        "name": args.speaker, "prompt_text": args.prompt_text,
        "wav_b64": wav_b64,
    }).encode())

    def one(i: int):
        req = json.dumps({
            "speaker": args.speaker, "text": _TEXTS[i % len(_TEXTS)],
        }).encode()
        t0 = time.perf_counter()
        body = synthesize(req)
        dt = time.perf_counter() - t0
        # WAV container: 44-byte header, 16-bit mono
        audio_s = max(0, (len(body) - 44)) / 2 / 24000
        return dt, audio_s

    for c in (int(x) for x in args.concurrency.split(",")):
        # warm the shapes at this concurrency before timing
        with cf.ThreadPoolExecutor(c) as ex:
            list(ex.map(one, range(c)))
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(c) as ex:
            res = list(ex.map(one, range(args.n)))
        wall = time.perf_counter() - t0
        point = sweep_point(c, [r[0] for r in res],
                            sum(r[1] for r in res), wall)
        if args.stream and c == 1:
            ttfbs, totals = _stream_times(syn_stream, args.speaker,
                                          args.ttfb_text, min(args.n, 8))
            point["ttfb_p50"] = percentile(ttfbs, 50)
            # total stream wall: ttfb << total is the decoupled-mode win
            # on multi-chunk texts (reference Triton decoupled mode,
            # runtime/nvidia_triton/README.md:146-157)
            point["stream_total_p50"] = percentile(totals, 50)
        print(json.dumps(point), flush=True)

    if args.stream_under_load:
        import threading

        stop = threading.Event()

        def bg(wid: int):
            i = wid
            while not stop.is_set():
                one(i)
                i += args.stream_under_load

        workers = [
            threading.Thread(target=bg, args=(w,), daemon=True)
            for w in range(args.stream_under_load)
        ]
        for t in workers:
            t.start()
        time.sleep(3)  # let the load reach steady state
        ttfbs, totals = _stream_times(syn_stream, args.speaker,
                                      args.ttfb_text, min(args.n, 8))
        stop.set()
        for t in workers:
            t.join(timeout=60)
        print(json.dumps({
            "stream_under_load": args.stream_under_load,
            "ttfb_p50": percentile(ttfbs, 50),
            "ttfb_p90": percentile(ttfbs, 90),
            "stream_total_p50": percentile(totals, 50),
        }), flush=True)


if __name__ == "__main__":
    main()
