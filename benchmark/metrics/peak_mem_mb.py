"""The peak of device memory allocated over set-up and window, in MB
(1e6 bytes): torch.cuda.max_memory_allocated."""


def read(run):
    return run.peak_bytes / 1e6 if run.peak_bytes else None
