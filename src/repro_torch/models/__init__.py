"""The LM plane's decoder stack (dense, mixture-of-experts, RWKV6 and the
Mamba2 / shared-attention hybrid): parameter specs and layers, attention
with bf16 or int8 KV caches, the MLP and MoE blocks, the RWKV6 and Mamba2
blocks with their recurrent states, and the stacked forward in train,
prefill and decode modes."""
