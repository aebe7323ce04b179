def evict_slowest(self, stream, tenant):
    with obs.span('serve.evict', cat='serve', tenant=tenant.tenant_id):
        stream.ring.evict(tenant.token)


def admit(self, stream, tenant_id):
    with obs.span('serve.admit', cat='serve', tenant=tenant_id):
        return stream.ring.join()
