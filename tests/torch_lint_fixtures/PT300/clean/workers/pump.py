import logging

logger = logging.getLogger(__name__)


def pump(q):
    try:
        q.get()
    except Exception:
        logger.exception('boom')
