"""WindToolKit data client with CSV caching.

Reference semantics (ssrs/wtk/wtk.py): find WTK grid points inside padded
lon/lat bounds by scanning the coordinates dataset, cache them as
``wtk_locations.csv``; per requested datetime, read each variable at
``time_index = hours since Jan 1`` divided by its ``scale_factor``
attribute and cache as ``y%Ym%md%dh%H_wtk.csv``; parallel downloads.
``pathos`` is unavailable so the fan-out uses a thread pool (the work is
network/IO bound)."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import TYPE_CHECKING, List, Tuple, Union

import numpy as np

from .wtksource import WtkSource

if TYPE_CHECKING:
    import pandas as pd


class WTK(WtkSource):
    """WTK importer (ssrs/wtk/wtk.py:13-192)."""

    datetime_format: str = 'y%Ym%md%dh%H'

    def __init__(self, source_name: str,
                 lonlat_bounds: Tuple[float, float, float, float],
                 varnames: Union[List[str], str],
                 out_dir: str,
                 padding: float = 0.02,
                 **source_kwargs):
        super().__init__(source_name, **source_kwargs)
        self.out_dir = out_dir
        os.makedirs(self.out_dir, exist_ok=True)
        pad = (-padding, -padding, padding, padding)
        self.lonlat_bounds = [v + p for v, p in zip(lonlat_bounds, pad)]
        varnames = [varnames] if isinstance(varnames, str) else varnames
        self.varnames = set(varnames).intersection(self.valid_layers)
        if self.varnames:
            print('WTK: layers to fetch: ' + ', '.join(sorted(self.varnames)))
        else:
            raise ValueError(
                'WTK: none of the requested layers exist in this source: '
                + ', '.join(varnames))

    def validate_requested_time(self, req_time: datetime) -> None:
        if not isinstance(req_time, datetime):
            raise ValueError('WTK: requested time must be a '
                             'datetime.datetime instance')
        if req_time.year not in self.years:
            raise ValueError(f'WTK: year {req_time.year} is outside this '
                             f'source\'s coverage {self.years}')

    # ---- locations -------------------------------------------------------

    def _bounds_fpath(self) -> str:
        return os.path.join(self.out_dir, 'wtk_locations_bounds.json')

    def download_locations(self) -> None:
        """Scan the coordinates dataset for points inside the bounds
        (ssrs/wtk/wtk.py:73-96) and record which bounds produced the cache."""
        import pandas as pd
        fpath = os.path.join(self.out_dir, 'wtk_locations.csv')
        with self.hsds.File(self.file_names[0], mode='r') as f_obj:
            lat_all = f_obj['coordinates'][:, 0]
            lat_idx = np.where((lat_all > self.lonlat_bounds[1])
                               & (lat_all < self.lonlat_bounds[3]))[0]
            lo, hi = int(lat_idx.min()), int(lat_idx.max())
            lon_band = f_obj['coordinates'][lo:hi, 1]
        lat_band = lat_all[lo:hi]
        inside = ((lat_band > self.lonlat_bounds[1])
                  & (lat_band < self.lonlat_bounds[3])
                  & (lon_band > self.lonlat_bounds[0])
                  & (lon_band < self.lonlat_bounds[2]))
        sel = np.where(inside)[0]
        pd.DataFrame({
            'Indices': lo + sel,
            'Longitude': lon_band[sel],
            'Latitude': lat_band[sel],
        }).to_csv(fpath)
        with open(self._bounds_fpath(), 'w', encoding='utf-8') as bf:
            json.dump({'lonlat_bounds': list(map(float, self.lonlat_bounds)),
                       'source': self.source_name}, bf)

    def _cached_locations_valid(self) -> bool:
        """True when the cached CSV was produced for the bounds this client
        was constructed with. The reference's invalidation check is inverted
        and silently reuses stale stations when the region changes
        (ssrs/wtk/wtk.py:101-109); here a sidecar records the generating
        bounds and any mismatch (or a missing sidecar) forces a re-scan."""
        try:
            with open(self._bounds_fpath(), 'r', encoding='utf-8') as bf:
                meta = json.load(bf)
            cached = meta.get('lonlat_bounds')
            return (meta.get('source') == self.source_name
                    and cached is not None
                    and np.allclose(cached, self.lonlat_bounds, atol=1e-9))
        except (FileNotFoundError, json.JSONDecodeError, TypeError):
            return False

    def get_locations(self) -> pd.DataFrame:
        """CSV-cached locations, invalidated when the requested bounds (or
        source) differ from the ones that produced the cache."""
        import pandas as pd
        fpath = os.path.join(self.out_dir, 'wtk_locations.csv')
        try:
            if not self._cached_locations_valid():
                raise FileNotFoundError
            dfbase = pd.read_csv(fpath, index_col=0)
            if dfbase.empty:
                raise FileNotFoundError
        except (FileNotFoundError, pd.errors.EmptyDataError):
            self.download_locations()
            dfbase = pd.read_csv(fpath, index_col=0)
        return dfbase

    # ---- per-datetime data ----------------------------------------------

    def download_data_for_this_time(self, req_time: datetime
                                    ) -> pd.DataFrame:
        """Extract all variables at one timestamp
        (ssrs/wtk/wtk.py:116-154)."""
        self.validate_requested_time(req_time)
        print(f'WTK: fetching wind conditions at '
              f'{req_time.strftime("%Y-%m-%d %H:00")}', flush=True)
        time_diff = req_time - datetime(req_time.year, 1, 1, 0)
        time_index = time_diff.days * 24 + time_diff.seconds // 3600

        newdf = self.get_locations()
        inds = newdf['Indices'].values
        source_fname = self.file_names[self.years.index(req_time.year)]
        with self.hsds.File(source_fname, mode='r') as fobj:
            for varname in self.varnames:
                try:
                    inorm = fobj[varname].attrs['scale_factor']
                    if self.module_name == 'h5pyd':
                        # one contiguous HSDS read, then subset
                        raw = fobj[varname][time_index,
                                            inds.min():inds.max() + 1] / inorm
                        newdf[varname] = raw[inds - inds.min()]
                    else:
                        newdf[varname] = fobj[varname][time_index,
                                                       inds] / inorm
                except Exception as exc:
                    raise ValueError(
                        f'WTK: layer {varname!r} could not be read; the '
                        f'source exposes {list(fobj)}') from exc
        newdf.to_csv(os.path.join(self.out_dir,
                                  self.get_filename(req_time)))
        return newdf

    def get_dataframe_for_this_time(self, req_time: datetime
                                    ) -> pd.DataFrame:
        """Cached read with index-consistency validation
        (ssrs/wtk/wtk.py:156-167)."""
        import pandas as pd
        fpath = os.path.join(self.out_dir, self.get_filename(req_time))
        dfbase = self.get_locations()
        try:
            newdf = pd.read_csv(fpath, index_col=0)
            if not newdf['Indices'].equals(dfbase['Indices']):
                raise FileNotFoundError
        except FileNotFoundError:
            print('WTK: no usable cache for this timestamp; fetching.')
            newdf = self.download_data_for_this_time(req_time)
        return newdf

    def download_data(self, req_times: Union[List[datetime], datetime],
                      max_cores: int = 1) -> None:
        """Fan out per-datetime downloads over a thread pool
        (ssrs/wtk/wtk.py:169-183; pathos process pool in the reference)."""
        req_times = [req_times] if isinstance(req_times, datetime) \
            else req_times
        # prime the location cache once to avoid a thundering herd
        self.get_locations()
        workers = max(min(len(req_times), max_cores), 1)
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(self.download_data_for_this_time, req_times))
        else:
            for t in req_times:
                self.download_data_for_this_time(t)

    def get_coordinates(self):
        dfbase = self.get_locations()
        return dfbase['Longitude'].values, dfbase['Latitude'].values

    def get_filename(self, at_time: datetime) -> str:
        return f'{at_time.strftime(self.datetime_format)}_wtk.csv'
