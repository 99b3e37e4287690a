from .catalog import ENV_IDS, make, make_functional

__all__ = ["ENV_IDS", "make", "make_functional"]
