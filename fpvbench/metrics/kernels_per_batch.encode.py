"""Device kernels launched in the window per batch section coded in it
(the file's delta section and footer ride with its batches)."""


def read(reading):
    batches = reading.counts.get("batches", 0)
    if not batches or not reading.trace.device:
        return None
    return len(reading.trace.kernels()) / batches
