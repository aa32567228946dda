from .cppn import CPPN, CPPNConfig, lecun_normal_

__all__ = ["CPPN", "CPPNConfig", "lecun_normal_"]
