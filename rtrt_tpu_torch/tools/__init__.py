"""Port of the JAX package's tools/ microbenchmarks: each module holds a
probe kernel's wrapper, its plain PyTorch version and a command-line entry
point that runs on the card (`python -m rtrt_tpu_torch.tools.<name>`)."""
