"""setup_s (s, host clock): process start to the window's first due time
— inputs made from the seed, the system built (k-means++ over the
warmup), the prefix ingested and published, the warm-up flushes."""


def read(rec):
    return rec["setup_s"]
