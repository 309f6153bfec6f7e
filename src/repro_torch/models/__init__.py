"""Dense decoder: layers, GQA attention with dense and paged KV caches,
model assembly and the serving entry points (prefill, decode_step)."""
