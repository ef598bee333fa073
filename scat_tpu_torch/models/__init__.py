"""Models of the port: the ResNet backbone, the token-pyramid transformer,
the flagship ``EncoderTransformer`` head and the Performer ``ViP``."""

from scat_tpu_torch.models.factory import build_model  # noqa: F401
