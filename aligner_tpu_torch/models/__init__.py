"""Alignment models: encoders, OTA, MoBo, RoMo, flax param conversion."""
from .encoders import MelEncoder, TextEncoder
from .mobo import MoBoAligner, MoBoConfig
from .ota import OTAAligner, OTAConfig
from .romo import RoMoAligner, RoMoConfig

__all__ = ["MelEncoder", "MoBoAligner", "MoBoConfig", "OTAAligner",
           "OTAConfig", "RoMoAligner", "RoMoConfig", "TextEncoder"]
