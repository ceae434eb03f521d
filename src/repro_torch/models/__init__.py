"""The LM plane's decoder stack (dense and mixture-of-experts families):
parameter specs and layers, attention with bf16 or int8 KV caches, the
MLP and MoE blocks, and the stacked forward in train, prefill and decode
modes."""
