from repro_torch.data.pipeline import SyntheticLMData, FileLMData  # noqa: F401
