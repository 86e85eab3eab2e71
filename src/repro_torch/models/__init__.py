"""The LM workload's model code in PyTorch.  Port of ``src/repro/models``:
config, params (with the sharding rules), sharding (the activation
policy), layers, attention (K2 on CUDA), ssm (K3 on CUDA), moe, rwkv,
transformer, encdec and model."""
