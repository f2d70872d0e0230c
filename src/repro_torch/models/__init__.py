"""The LM stack of the port: architecture configs, layers and the dense
transformer (prefill + decode with a KV cache)."""
