from portbench.readers import mfu as read  # noqa: F401
