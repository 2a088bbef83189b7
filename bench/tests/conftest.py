import os

os.environ.setdefault("OMP_NUM_THREADS", "2")
