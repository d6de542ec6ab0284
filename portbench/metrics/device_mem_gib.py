"""device_mem_gib: the most card memory the chemistry holds, GiB: the
largest torch.cuda.memory_reserved() read after set-up and after each
call of the window.  Not the allocator's peak counter, which the port's
graph cache resets at every eager call."""


def read(run):
    if not run.on_card:
        return None
    return run.reserved_max_bytes / 2**30
