def pump(q):
    try:
        q.get()
    except Exception:
        pass
