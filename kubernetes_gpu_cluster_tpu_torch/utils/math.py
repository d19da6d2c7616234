"""Small math helpers used across the engine and kernels."""


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple of ``multiple``."""
    return cdiv(x, multiple) * multiple


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x (>=1). Used for shape bucketing so the
    jit cache stays small under continuous batching (no recompilation storms)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()
