"""peak_mem_gib: the allocator's peak over the timed window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``)
less what the benchmark itself holds (the pool of right-hand sides and the
buffers it copies answers into), in GiB: the operator, the preconditioner
and the solver's working memory."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return (run.peak_window_bytes - run.bench_bytes) / 2 ** 30
