"""Entry points: ``serve`` (the serving launcher) and ``mesh`` (the
device grid the sharded engine runs on)."""
