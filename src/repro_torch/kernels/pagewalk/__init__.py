from repro_torch.kernels.pagewalk.ops import two_stage_translate  # noqa: F401
