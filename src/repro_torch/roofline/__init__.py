from repro_torch.roofline.analysis import analyze_all, HW  # noqa: F401
