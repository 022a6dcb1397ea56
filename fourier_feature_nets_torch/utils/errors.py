"""The error of a path the port does not have yet."""

__all__ = ["not_ported"]


def not_ported(what: str, item: str) -> NotImplementedError:
    """``NotImplementedError`` for ``what``, naming the ROADMAP.md
    queue-1 item (by its title) that ports it."""
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet; see ROADMAP.md, queue 1, "
        f"'{item}'")
