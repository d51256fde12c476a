from .synthetic import jsc_synthetic

__all__ = ["jsc_synthetic"]
