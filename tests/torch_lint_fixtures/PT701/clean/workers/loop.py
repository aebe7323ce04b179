def worker_loop(q):
    try:
        q.get()
    except BaseException:
        raise
