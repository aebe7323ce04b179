from petastorm_tpu_torch import observability as obs


def process():
    with obs.stage('decode', cat='worker'):
        do_work()


def do_work():
    pass
