"""User-supplied row/batch transforms executed on the decode workers.

Twin of ``petastorm_tpu/transform.py``, decode-time ``image_resize`` and
``image_decode_hints`` included.
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
    :param image_decode_hints: ``{field_name: (min_h, min_w)}``: a promise
        that ``func`` downscales these image fields to at most that size, which
        lets the worker decode JPEGs at the smallest libjpeg m/8 DCT scale
        still covering the minimum. ``func`` must therefore take images of any
        size at least the hint (or the original size, if smaller). PNG fields
        are unaffected (the format has no scaled decode).
    :param image_resize: ``{field_name: (out_h, out_w)}``: resize these image
        fields to EXACTLY that size during decode, before ``func`` runs. The
        column decodes into one ``[N, out_h, out_w(, C)]`` block under the
        shared resize policy (``codecs._resize_image``). Implies the decode
        hint for the field unless one is given. The post-transform schema's
        shape for the field follows unless ``edit_fields`` overrides it.
    """

    def __init__(self, func=None, edit_fields=None, removed_fields=None, selected_fields=None,
                 batched=False, image_decode_hints=None, image_resize=None):
        self.func = func
        self.edit_fields = [self._as_field(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None
        self.batched = batched
        self.image_decode_hints = dict(image_decode_hints or {})
        self.image_resize = {}
        for name, size in (image_resize or {}).items():
            try:
                # a str would pass len()==2 per character ('24' -> (2, 4))
                ok = (not isinstance(size, (str, bytes))
                      and len(size) == 2 and int(size[0]) >= 1 and int(size[1]) >= 1)
            except (TypeError, ValueError):  # a scalar, or non-numeric elements
                ok = False
            if not ok:
                raise ValueError('image_resize[{!r}] must be a positive (out_h, out_w), '
                                 'got {!r}'.format(name, size))
            self.image_resize[name] = (int(size[0]), int(size[1]))
            # resizing to the target IS the downscale promise scaled JPEG
            # decode needs; an explicit hint wins
            self.image_decode_hints.setdefault(name, self.image_resize[name])

    @staticmethod
    def _as_field(field_or_tuple):
        if isinstance(field_or_tuple, UnischemaField):
            return field_or_tuple
        name, numpy_dtype, shape, nullable = field_or_tuple
        return UnischemaField(name, numpy_dtype, shape, nullable=nullable)


def transform_schema(schema, transform_spec):
    """Derive the post-transform schema."""
    removed = set(transform_spec.removed_fields)
    edited = {f.name: f for f in transform_spec.edit_fields}
    fields = {f.name: f for f in schema if f.name not in removed}
    fields.update(edited)
    for name, (out_h, out_w) in transform_spec.image_resize.items():
        # checked against the ORIGINAL schema (func may consume or remove a
        # resized field): only codecs that resize at decode time qualify, so
        # anything else fails here instead of yielding unresized data under
        # a schema that claims the new size
        src = schema.fields.get(name)
        if src is None:
            raise ValueError('image_resize refers to unknown field {!r}'.format(name))
        if not getattr(src.codec, 'supports_image_resize', False):
            raise ValueError(
                'image_resize[{!r}]: field is stored with {}, which does not support '
                'decode-time resize (only image codecs do); resize it in the transform '
                'func instead'.format(name, type(src.codec).__name__))
        # decode-time resize pins the leading H, W dims; explicit edits win
        f = fields.get(name)
        if f is not None and name not in edited and f.shape is not None and len(f.shape) >= 2:
            fields[name] = UnischemaField(f.name, f.numpy_dtype,
                                          (out_h, out_w) + tuple(f.shape[2:]),
                                          f.codec, f.nullable)
    if transform_spec.selected_fields is not None:
        missing = [n for n in transform_spec.selected_fields if n not in fields]
        if missing:
            raise ValueError('selected_fields not present after transform: {}'.format(missing))
        fields = {n: fields[n] for n in transform_spec.selected_fields}
    return Unischema('{}_transformed'.format(schema.name), list(fields.values()))
