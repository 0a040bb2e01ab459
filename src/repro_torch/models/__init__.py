from repro_torch.models.transformer import init_cache, init_params  # noqa: F401
