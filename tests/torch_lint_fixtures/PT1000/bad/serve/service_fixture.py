def evict_slowest(self, stream, tenant):
    stream.ring.evict(tenant.token)


def admit(self, stream):
    return stream.ring.join()
