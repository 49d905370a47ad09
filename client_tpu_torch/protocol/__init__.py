"""KServe v2 wire protocol: dtypes, tensor codec, REST framing, and the
gRPC schema, stub, codec and model-config conversion."""
