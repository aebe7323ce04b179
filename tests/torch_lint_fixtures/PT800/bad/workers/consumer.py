from petastorm_tpu_torch.workers.protocol import MSG_DATA, MSG_DONE


def consume(kind, payload):
    if kind == MSG_DATA:
        return payload
    elif kind == MSG_DONE:
        return None
