"""The LM workload's model code in PyTorch.  Port of ``src/repro/models``:
config, params, layers, attention (K2 on CUDA), ssm (K3 on CUDA),
transformer and model.  The MoE, MLA, RWKV and encoder-decoder families
are not ported yet (see ``ROADMAP.md``)."""
