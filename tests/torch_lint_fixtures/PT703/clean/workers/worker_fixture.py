from petastorm_tpu_torch import observability as obs


def process_item(worker, args, ctx):
    # the propagated context is installed; every span inside inherits it
    with obs.use_trace(ctx):
        with obs.stage('decode', cat='worker'):
            worker.process(*args)


def wait_for_result(pool):
    with obs.stage('pool_wait', cat='pool') as sp:
        payload = pool.get()
        # identity discovered mid-flight is adopted via link, never kwargs
        sp.link(pool.last_result_trace)
        return payload
