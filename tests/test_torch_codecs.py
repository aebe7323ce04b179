"""The port's codecs, resize policy, unischema default and TransformSpec
image options against the JAX package's, on values made with numpy from a
seed. Codecs that encode through OpenCV or ``np.save`` give equal bytes in
both packages, every cell decodes the same in both (exact), and the resize
policy gives the same pixels in both on each of its three routes (cv2, the
native resampler, numpy), forced by hiding cv2 and the native library in
both packages."""

import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu.codecs as jax_codecs
import petastorm_tpu.native.image_codec as jax_native
import petastorm_tpu_torch.codecs as codecs
import petastorm_tpu_torch.native.image_codec as native
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu.transform import transform_schema as jax_transform_schema
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec, NdarrayCodec,
                                        ScalarListCodec, image_routes)
from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.transform import TransformSpec, transform_schema
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

CODEC_PAIRS = {
    'ndarray': (NdarrayCodec(), jax_codecs.NdarrayCodec()),
    'compressed_ndarray': (CompressedNdarrayCodec(), jax_codecs.CompressedNdarrayCodec()),
    'png': (CompressedImageCodec('png'), jax_codecs.CompressedImageCodec('png')),
    'jpeg': (CompressedImageCodec('jpeg', 90), jax_codecs.CompressedImageCodec('jpeg', 90)),
}


def _value(kind, rng):
    if kind in ('png', 'jpeg'):
        return rng.integers(0, 256, (21, 34, 3), dtype=np.uint8), np.uint8, (None, None, 3)
    return rng.standard_normal((3, 5)).astype(np.float32), np.float32, (None, 5)


@pytest.mark.parametrize('kind', sorted(CODEC_PAIRS))
def test_codec_bytes_and_cross_decode(kind):
    ours, theirs = CODEC_PAIRS[kind]
    value, dtype, shape = _value(kind, np.random.default_rng(0))
    field = UnischemaField('f', dtype, shape, ours)
    jfield = JaxField('f', dtype, shape, theirs)
    mine, ref = ours.encode(field, value), theirs.encode(jfield, value)
    if kind != 'compressed_ndarray':  # npz members carry the write time
        assert mine == ref
    for cell in (mine, ref):
        np.testing.assert_array_equal(ours.decode(field, cell), theirs.decode(jfield, cell))
    assert ours.to_json() == theirs.to_json()
    assert codecs.codec_from_json(theirs.to_json()) == ours
    assert ours.preferred_column_compression == theirs.preferred_column_compression


def test_png_uint16_and_gray_round_trip_like_jax():
    rng = np.random.default_rng(1)
    for value, shape in ((rng.integers(0, 65536, (9, 12, 3), dtype=np.uint16), (None, None, 3)),
                         (rng.integers(0, 256, (9, 12), dtype=np.uint8), (None, None))):
        field = UnischemaField('f', value.dtype, shape, CompressedImageCodec('png'))
        jfield = JaxField('f', value.dtype, shape, jax_codecs.CompressedImageCodec('png'))
        cell = field.codec.encode(field, value)
        assert cell == jfield.codec.encode(jfield, value)
        np.testing.assert_array_equal(field.codec.decode(field, cell), value)


def test_codec_validation_matches_jax():
    rng = np.random.default_rng(2)
    bad = [('jpeg', rng.integers(0, 65536, (4, 4), dtype=np.uint16), (None, None)),
           ('png', rng.standard_normal((4, 4)).astype(np.float32), (None, None)),
           ('png', rng.integers(0, 256, (4, 4, 3), dtype=np.uint8), (None, None))]
    for fmt, value, shape in bad:
        with pytest.raises(SchemaError):
            CompressedImageCodec(fmt).encode(UnischemaField('f', value.dtype, shape), value)
        with pytest.raises(jax_codecs.SchemaError):
            jax_codecs.CompressedImageCodec(fmt).encode(JaxField('f', value.dtype, shape), value)
    with pytest.raises(SchemaError):
        CompressedImageCodec('webp')
    with pytest.raises(SchemaError, match='1-D'):
        ScalarListCodec().encode(UnischemaField('f', np.int32, (None,)), np.zeros((2, 2)))


@pytest.mark.parametrize('flavor', ['uniform', 'ragged', 'fortran', 'empty-cells'])
def test_ndarray_decode_column_matches_jax(flavor):
    rng = np.random.default_rng(3)
    if flavor == 'uniform':
        values = [rng.integers(0, 9, (4, 3)).astype(np.int16) for _ in range(5)]
    elif flavor == 'ragged':
        values = [rng.standard_normal((i + 1, 2)) for i in range(4)]
    elif flavor == 'fortran':
        values = [np.asfortranarray(rng.standard_normal((3, 4))) for _ in range(3)]
    else:
        values = [np.zeros((0, 3), np.float32) for _ in range(3)]
    jfield = JaxField('f', values[0].dtype, (None,) * values[0].ndim, jax_codecs.NdarrayCodec())
    field = UnischemaField('f', values[0].dtype, (None,) * values[0].ndim)
    assert isinstance(field.codec, NdarrayCodec)  # the default for a non-scalar field
    cells = [jfield.codec.encode(jfield, v) for v in values]
    column = pa.chunked_array([pa.array(cells, pa.binary())])
    ours = field.codec.decode_column(field, column)
    ref = jfield.codec.decode_column(jfield, column)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    for cell, value in zip(cells, values):
        np.testing.assert_array_equal(field.codec.decode(field, cell), value)
        assert field.codec.decode(field, cell).flags.writeable


@pytest.mark.parametrize('rows', [[[1, 2, 3], [4, 5, 6]], [[1], [2, 3]], [[]]])
def test_scalar_list_codec_matches_jax(rows):
    field = UnischemaField('f', np.int32, (None,), ScalarListCodec())
    jfield = JaxField('f', np.int32, (None,), jax_codecs.ScalarListCodec())
    cells = [field.codec.encode(field, np.array(r, np.int32)) for r in rows]
    assert cells == [jfield.codec.encode(jfield, np.array(r, np.int32)) for r in rows]
    column = pa.chunked_array([pa.array(cells, field.codec.arrow_type(field))])
    ours = field.codec.decode_column(field, column)
    ref = jfield.codec.decode_column(jfield, column)
    assert (ours is None) == (ref is None)
    if ours is not None:
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == np.int32
    for cell in cells:
        np.testing.assert_array_equal(field.codec.decode(field, cell),
                                      jfield.codec.decode(jfield, cell))


def test_unischema_json_round_trips_between_packages():
    fields = [('image', np.uint8, (None, None, 3), CompressedImageCodec('jpeg', 77),
               jax_codecs.CompressedImageCodec('jpeg', 77)),
              ('tensor', np.float32, (None, 4), None, None),
              ('packed', np.float64, (2, 2), CompressedNdarrayCodec(),
               jax_codecs.CompressedNdarrayCodec()),
              ('ids', np.int64, (None,), ScalarListCodec(), jax_codecs.ScalarListCodec())]
    ours = Unischema('S', [UnischemaField(n, d, s, c) for n, d, s, c, _ in fields])
    theirs = JaxUnischema('S', [JaxField(n, d, s, j) for n, d, s, _, j in fields])
    assert ours.to_json() == theirs.to_json()
    assert Unischema.from_json(theirs.to_json()).to_json() == ours.to_json()
    assert str(ours.as_arrow_schema()) == str(theirs.as_arrow_schema())


# -- the resize policy, route by route -----------------------------------------------

SHAPES = {
    'down-2x': ((40, 50), (13, 17)),     # area: decimation of 2x or more
    'mild': ((40, 50), (30, 40)),        # bilinear: both axes under 2x
    'upscale': ((40, 50), (64, 80)),     # bilinear
    'mixed': ((40, 50), (20, 70)),       # bilinear: one axis down, one up
    'same': ((40, 50), (40, 50)),        # untouched
}


def _hide_cv2(monkeypatch):
    def no_cv2():
        raise ImportError('cv2 hidden by the test')
    monkeypatch.setattr(codecs, '_import_cv2', no_cv2)
    monkeypatch.setattr(jax_codecs, '_import_cv2', no_cv2)


def _hide_native(monkeypatch):
    for module in (native, jax_native):
        monkeypatch.setattr(module, '_load_failed', True)
        monkeypatch.setattr(module, '_lib', None)


@pytest.mark.parametrize('route', ['cv2', 'native', 'numpy'])
@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_resize_policy_matches_jax_on_each_route(route, shape, monkeypatch):
    (h, w), (out_h, out_w) = SHAPES[shape]
    img = np.random.default_rng(4).integers(0, 256, (h, w, 3), dtype=np.uint8)
    if route != 'cv2':
        _hide_cv2(monkeypatch)
    if route == 'numpy':
        _hide_native(monkeypatch)
    image_routes.reset()
    ours = codecs._resize_image(img, out_h, out_w)
    ref = jax_codecs._resize_image(img, out_h, out_w)
    assert ours.shape == (out_h, out_w, 3)
    np.testing.assert_array_equal(ours, ref)
    counts = image_routes.snapshot()
    assert counts['resize_' + route] == (0 if shape == 'same' else 1)
    assert sum(counts.values()) == counts['resize_' + route]
    dst = np.empty_like(ours)
    assert codecs._resize_image(img, out_h, out_w, dst=dst) is dst
    np.testing.assert_array_equal(dst, ref)


def test_resize_uint16_takes_numpy_without_cv2(monkeypatch):
    _hide_cv2(monkeypatch)
    img = np.random.default_rng(5).integers(0, 65536, (20, 24, 3), dtype=np.uint16)
    image_routes.reset()
    ours = codecs._resize_image(img, 7, 9)
    np.testing.assert_array_equal(ours, jax_codecs._resize_image(img, 7, 9))
    assert ours.dtype == np.uint16 and image_routes.snapshot()['resize_numpy'] == 1


def test_mild_ratio_matches_jax():
    for args in [(10, 10, 5, 5), (10, 10, 6, 6), (10, 10, 20, 3), (9, 30, 5, 14), (4, 4, 4, 4)]:
        assert codecs._mild_ratio(*args) == jax_codecs._mild_ratio(*args)


# -- whole-column image decode ------------------------------------------------------

def _image_column(rng, fmt, uniform):
    codec = jax_codecs.CompressedImageCodec(fmt)
    field = JaxField('image', np.uint8, (None, None, 3), codec)
    dims = [(30, 40)] * 5 if uniform else [tuple(rng.integers(20, 60, 2)) for _ in range(5)]
    cells = [codec.encode(field, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
             for h, w in dims]
    return field, pa.chunked_array([pa.array(cells, pa.binary())])


@pytest.mark.parametrize('route', ['native+cv2', 'native', 'cv2'])
@pytest.mark.parametrize('fmt', ['png', 'jpeg'])
@pytest.mark.parametrize('hints', [{}, {'resize': (24, 24)}, {'min_size': (16, 16)},
                                   {'min_size': (48, 48), 'resize': (24, 30)}],
                         ids=['plain', 'resize', 'hint', 'hint+resize'])
def test_decode_column_and_batch_match_jax(route, fmt, hints, monkeypatch):
    rng = np.random.default_rng(6)
    columns = [_image_column(rng, fmt, uniform) for uniform in (True, False)]
    if route == 'native':
        _hide_cv2(monkeypatch)
    elif route == 'cv2':
        _hide_native(monkeypatch)
    for jfield, column in columns:
        field = UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec(fmt))
        ours = field.codec.decode_column(field, column, **hints)
        ref = jfield.codec.decode_column(jfield, column, **hints)
        assert (ours is None) == (ref is None)
        if ours is not None:
            assert ours.dtype == ref.dtype and ours.shape == ref.shape
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, b)
        cells = [c.as_py() for c in column.chunk(0)] + [None]
        ours = field.codec.decode_batch(field, cells, **hints)
        ref = jfield.codec.decode_batch(jfield, cells, **hints)
        assert ours[-1] is None and ref[-1] is None
        for a, b in zip(ours[:-1], ref[:-1]):
            np.testing.assert_array_equal(a, b)


def test_decode_routes_are_counted(monkeypatch):
    jfield, column = _image_column(np.random.default_rng(7), 'png', uniform=False)
    field = UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('png'))
    image_routes.reset()
    field.codec.decode_column(field, column, resize=(25, 25))
    assert image_routes.snapshot() == {'decode_native': 5, 'decode_cv2': 0, 'decode_fallback': 0,
                                       'resize_cv2': 5, 'resize_native': 0, 'resize_numpy': 0}
    _hide_cv2(monkeypatch)
    image_routes.reset()
    field.codec.decode_column(field, column, resize=(25, 25))  # the fused native call
    assert image_routes.snapshot()['resize_native'] == 5
    _hide_native(monkeypatch)
    assert field.codec.decode_column(field, column) is None
    with pytest.raises(SchemaError, match='did not build or load.*OpenCV'):
        field.codec.decode_batch(field, [c.as_py() for c in column.chunk(0)])


# -- TransformSpec image options ----------------------------------------------------

def _schemas():
    spec = [('image', np.uint8, (None, None, 3), CompressedImageCodec('png'),
             jax_codecs.CompressedImageCodec('png')),
            ('label', np.int64, (), None, None),
            ('raw', np.uint8, (4, 4), codecs.RawTensorCodec(), jax_codecs.RawTensorCodec())]
    return (Unischema('S', [UnischemaField(n, d, s, c) for n, d, s, c, _ in spec]),
            JaxUnischema('S', [JaxField(n, d, s, j) for n, d, s, _, j in spec]))


@pytest.mark.parametrize('kwargs', [
    {'image_resize': {'image': (32, 48)}},
    {'image_resize': {'image': [32, 48]}, 'image_decode_hints': {'image': (64, 64)}},
    {'image_decode_hints': {'image': (10, 10)}},
    {'image_resize': {'image': (8, 8)}, 'edit_fields': [('image', np.uint8, (8, 8), False)]},
    {'image_resize': {'image': (8, 8)}, 'removed_fields': ['image']},
], ids=['resize', 'resize+hint', 'hint', 'edited', 'removed'])
def test_transform_spec_image_options_match_jax(kwargs):
    ours, theirs = TransformSpec(**kwargs), JaxTransformSpec(**kwargs)
    assert ours.image_resize == theirs.image_resize
    assert ours.image_decode_hints == theirs.image_decode_hints
    schema, jschema = _schemas()
    assert (transform_schema(schema, ours).to_json()['fields']
            == jax_transform_schema(jschema, theirs).to_json()['fields'])


@pytest.mark.parametrize('bad', [(0, 4), (4,), '24', 5, ('a', 'b')])
def test_transform_spec_rejects_bad_sizes_like_jax(bad):
    with pytest.raises(ValueError, match='positive'):
        TransformSpec(image_resize={'image': bad})
    with pytest.raises(ValueError, match='positive'):
        JaxTransformSpec(image_resize={'image': bad})


@pytest.mark.parametrize('name,match', [('nope', 'unknown field'), ('raw', 'RawTensorCodec'),
                                        ('label', 'ScalarCodec')])
def test_transform_schema_refuses_fields_that_cannot_resize(name, match):
    schema, jschema = _schemas()
    with pytest.raises(ValueError, match=match):
        transform_schema(schema, TransformSpec(image_resize={name: (8, 8)}))
    with pytest.raises(ValueError, match=match):
        jax_transform_schema(jschema, JaxTransformSpec(image_resize={name: (8, 8)}))
