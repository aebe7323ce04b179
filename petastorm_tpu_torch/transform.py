"""User-supplied row/batch transforms executed on the decode workers.

Twin of ``petastorm_tpu/transform.py``. Decode-time ``image_resize`` needs the
image codecs, which are not ported yet, so asking for it raises.
"""

from __future__ import annotations

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec(object):
    """A transform applied on the worker to each row dict, or, with
    ``batched=True``, to the whole column block of a row group.

    :param func: callable returning the transformed dict, or ``None`` if only
        field editing/removal is needed
    :param edit_fields: :class:`UnischemaField` s (or ``(name, numpy_dtype,
        shape, nullable)`` tuples) added or replaced by ``func``
    :param removed_fields: names of fields ``func`` removes
    :param selected_fields: explicit post-transform field-name whitelist
    :param batched: ``func`` receives and returns a dict of whole columns
    """

    def __init__(self, func=None, edit_fields=None, removed_fields=None, selected_fields=None,
                 batched=False, image_decode_hints=None, image_resize=None):
        if image_resize or image_decode_hints:
            raise NotImplementedError(
                'TransformSpec image_resize/image_decode_hints need the image codecs, which are '
                'not yet ported to petastorm_tpu_torch (ROADMAP.md, "CompressedImageCodec + '
                'image_resize")')
        self.func = func
        self.edit_fields = [self._as_field(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None
        self.batched = batched

    @staticmethod
    def _as_field(field_or_tuple):
        if isinstance(field_or_tuple, UnischemaField):
            return field_or_tuple
        name, numpy_dtype, shape, nullable = field_or_tuple
        return UnischemaField(name, numpy_dtype, shape, nullable=nullable)


def transform_schema(schema, transform_spec):
    """Derive the post-transform schema."""
    removed = set(transform_spec.removed_fields)
    fields = {f.name: f for f in schema if f.name not in removed}
    fields.update({f.name: f for f in transform_spec.edit_fields})
    if transform_spec.selected_fields is not None:
        missing = [n for n in transform_spec.selected_fields if n not in fields]
        if missing:
            raise ValueError('selected_fields not present after transform: {}'.format(missing))
        fields = {n: fields[n] for n in transform_spec.selected_fields}
    return Unischema('{}_transformed'.format(schema.name), list(fields.values()))
