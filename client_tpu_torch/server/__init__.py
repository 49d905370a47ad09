"""Network frontends over :class:`client_tpu_torch.engine.TorchEngine`."""

from client_tpu_torch.server.grpc_server import GrpcInferenceServer
from client_tpu_torch.server.http_server import HttpInferenceServer

__all__ = ["GrpcInferenceServer", "HttpInferenceServer"]
