"""The LM plane's decoder stack (dense family): parameter specs and
layers, attention with bf16 or int8 KV caches, the MLP, and the stacked
forward in train, prefill and decode modes."""
