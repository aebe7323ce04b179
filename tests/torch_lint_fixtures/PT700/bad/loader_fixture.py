from petastorm_tpu_torch import observability as obs


def process():
    obs.stage('decode')
    do_work()


def do_work():
    pass
