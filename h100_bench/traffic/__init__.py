"""The traffic generator and the mixes it reads (``<mix>.json``)."""
