"""The plain PyTorch reference of the benchmark's models: f32, no kernel,
cache or batching, written from the architecture (DeepHumor's
``CaptioningTransformer``: a ResNet-50 encoder and a post-LN
cross-attention decoder). It imports nothing of the program and takes
nothing that the program made: it is handed the seeded weights and
inputs that the program is handed, and the program's outputs only to
judge them."""
