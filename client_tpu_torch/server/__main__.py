"""Server launcher: ``python -m client_tpu_torch.server``.

    python -m client_tpu_torch.server --zoo bert_base,bert_long --http-port 8000
    python -m client_tpu_torch.server --zoo tiny_gpt,tiny_gpt_long --grpc-port 8001
    python -m client_tpu_torch.server --zoo simple,simple_string --device cpu
    python -m client_tpu_torch.server --zoo image_preprocess,resnet50,ensemble_image
    python -m client_tpu_torch.server --model-repository models/ --device cpu
    python -m client_tpu_torch.server --zoo bert_long,tiny_gpt_long --warmup

One engine serves both frontends: HTTP (``--http-port``, default 8000) and
gRPC (``--grpc-port``, default 8001); ``--no-http`` or ``--no-grpc`` leaves
one out. ``tiny_gpt`` and ``tiny_gpt_long`` stream tokens through
``POST /v2/models/<m>/generate_stream`` (server-sent events),
``/generate`` and the gRPC ``ModelStreamInfer`` stream. An ensemble is
served only beside the composing models it names.

``--model-repository DIR`` serves a directory repository (one
``<model>/config.pbtxt`` or ``config.json`` each, numbered version
directories; the file is the serving contract and the port's zoo supplies
the executable), with ``--zoo`` models registered beside it. Every
model's state is printed, with the reason of one that failed to load.
Models load and unload at run time over ``POST
/v2/repository/models/<m>/{load,unload}`` and the gRPC
``RepositoryModelLoad`` / ``RepositoryModelUnload``.

``--warmup`` (or ``CLIENT_TPU_WARMUP=1``) runs every bucket of each model
once on zeros before serving, so no first request is cold; the tuning
planes read ``CLIENT_TPU_QOS``, ``CLIENT_TPU_AUTOTUNE`` and
``CLIENT_TPU_SELFDRIVE``.

Serves on the card unless ``--device cpu`` is given; without CUDA and
without that flag it exits with an error. SIGTERM drains it
(``admission/drain.py``): readiness turns off, new requests get 503 with
``Retry-After``, the requests in flight finish within
``--drain-deadline`` seconds (default 30), then it exits 0. Ctrl-C stops
it at once.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="client_tpu_torch.server",
        description="PyTorch/CUDA inference server (KServe v2 HTTP + gRPC)")
    ap.add_argument("--model-repository", metavar="DIR", default=None,
                    help="directory of <model>/config.pbtxt model configs")
    ap.add_argument("--zoo", metavar="NAMES", default=None,
                    help="comma-separated zoo models to serve (default: "
                         "every default model, when no --model-repository)")
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument("--grpc-port", type=int, default=8001)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--no-http", action="store_true")
    ap.add_argument("--no-grpc", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--drain-deadline", type=float, default=30.0,
                    metavar="SECONDS",
                    help="max seconds to drain in-flight requests on "
                         "SIGTERM before forcing shutdown (default 30)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every bucket once on zeros at load, so no "
                         "request meets a cold bucket")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.no_http and args.no_grpc:
        ap.error("nothing to serve (--no-http and --no-grpc)")

    from client_tpu_torch.admission.drain import install_sigterm_handler
    from client_tpu_torch.engine import EngineError, TorchEngine
    from client_tpu_torch.engine.repository import ModelRepository
    from client_tpu_torch.models import _REGISTRY, build_repository, model_names
    from client_tpu_torch.server import (
        GrpcInferenceServer,
        HttpInferenceServer,
    )

    names = ([n.strip() for n in args.zoo.split(",") if n.strip()]
             if args.zoo else None)
    unknown = sorted(set(names or ()) - set(model_names()))
    if unknown:
        ap.error(f"unknown zoo model(s) {unknown}; "
                 f"available: {', '.join(model_names())}")
    if args.model_repository:
        try:
            repo = ModelRepository.from_directory(args.model_repository)
        except EngineError as exc:
            ap.error(str(exc))
        for name in names or ():
            repo.register(name, _REGISTRY[name])
    else:
        repo = build_repository(names)
    engine = TorchEngine(repo, device=args.device,
                         warmup=True if args.warmup else None)
    for entry in engine.repository_index():
        line = f"model {entry['name']}: {entry['state']}"
        if entry.get("reason"):
            line += f" ({entry['reason']})"
        print(line, file=sys.stderr, flush=True)
    http_servers = [] if args.no_http else [HttpInferenceServer(
        engine, host=args.host, port=args.http_port,
        verbose=args.verbose).start()]
    grpc_servers = [] if args.no_grpc else [GrpcInferenceServer(
        engine, host=args.host, port=args.grpc_port).start()]
    # The handler goes in before the addresses are announced: a caller
    # that reads them may send SIGTERM at once.
    drained = install_sigterm_handler(
        engine, http_servers=http_servers, grpc_servers=grpc_servers,
        deadline_s=args.drain_deadline,
        on_done=lambda report: print(f"drain: {report}", file=sys.stderr,
                                     flush=True))
    for kind, server in ([("http", s) for s in http_servers]
                         + [("grpc", s) for s in grpc_servers]):
        print(f"serving {kind} at {server.url}", file=sys.stderr, flush=True)
    try:
        while not drained.wait(timeout=3600):
            pass
        print("drained; exiting", file=sys.stderr, flush=True)
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr, flush=True)
        for server in http_servers + grpc_servers:
            server.stop()
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
