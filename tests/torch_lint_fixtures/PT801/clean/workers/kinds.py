from petastorm_tpu_torch.workers.protocol import MSG_DATA


def is_data(kind):
    return kind == MSG_DATA
