"""KServe v2 wire protocol: dtypes, tensor codec, REST framing."""
