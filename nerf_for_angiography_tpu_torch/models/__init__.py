from .cppn import (
    CPPN,
    CPPNConfig,
    barf_alpha_device,
    barf_alpha_schedule,
    barf_k_values,
    barf_weights,
    lecun_normal_,
    sine,
)

__all__ = [
    "CPPN",
    "CPPNConfig",
    "barf_alpha_device",
    "barf_alpha_schedule",
    "barf_k_values",
    "barf_weights",
    "lecun_normal_",
    "sine",
]
