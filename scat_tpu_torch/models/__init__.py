"""Models of the port: the ResNet, HRNet and Inception-v3 backbones, the
token-pyramid transformers, the flagship ``EncoderTransformer``, the
coarse head, the 128-token heads and the Performer ``ViP``."""

from scat_tpu_torch.models.factory import build_model  # noqa: F401
