"""Models of the port: the ResNet backbone, the token-pyramid transformer
and the flagship ``EncoderTransformer`` head."""

from scat_tpu_torch.models.factory import build_model  # noqa: F401
