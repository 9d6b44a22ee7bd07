from .rmsnorm import LAUNCHES, reset_launches, rmsnorm, rmsnorm_plain

__all__ = ["LAUNCHES", "reset_launches", "rmsnorm", "rmsnorm_plain"]
