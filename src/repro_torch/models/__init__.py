"""The LM stack and the CNN models planned as one graph program."""
from repro_torch.models import lm, cnn  # noqa: F401
