from .runner import SequenceResult, SequenceRunner  # noqa: F401
