"""US Wind Turbine Database (USWTDB) client.

Reference semantics (ssrs/turbines.py): fetch the USWTDB REST JSON,
reproject turbine locations into the run CRS, filter to bounds and minimum
hub height, expose per-project queries and a formatted summary. On any
connection failure ``dframe`` is None and all turbine plotting silently
skips (ssrs/turbines.py:46-49, ssrs/simulator.py:694). Fixes the
reference's save-path bug (undefined ``fpath`` swallowed by a bare
except, ssrs/turbines.py:72-76)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

from .crs import transform_coordinates

if TYPE_CHECKING:
    import pandas as pd


class TurbinesUSWTB:
    """USWTDB turbine data (ssrs/turbines.py:10-121)."""

    url = ('https://eersc.usgs.gov/api/uswtdb/v1/turbines?&t_cap=gt.0&'
           'select=t_state,p_name,p_year,t_cap,t_hh,t_rd,xlong,ylat')
    lonlat_crs = 'EPSG:4326'

    def __init__(self, bounds: Tuple[float, float, float, float],
                 crs_string: str = 'EPSG:4326',
                 min_hubheight: float = 50.,
                 out_fpath: Optional[str] = 'turbines.csv',
                 print_verbose: bool = False,
                 dataframe: Optional[pd.DataFrame] = None):
        """``dataframe`` injects raw USWTDB-shaped data (offline fixtures);
        otherwise the REST endpoint is queried. pandas and requests are
        imported only for that query: without them, as without a
        network, there is no turbine data (``dframe`` is None)."""
        print('TurbinesUSWTB: Importing turbine data from USWTB..')
        if dataframe is not None:
            dfraw = dataframe
        else:
            try:
                import io
                import pandas as pd
                import requests
                resp = requests.get(self.url, timeout=(4, 120))
                resp.raise_for_status()
                dfraw = pd.read_json(io.BytesIO(resp.content))
            except Exception:
                print('Connection issues with USWTB database!')
                self.dframe = None
                return

        if crs_string.lower() != 'epsg:4326':
            self._xcol, self._ycol = 'x', 'y'
            xlocs, ylocs = transform_coordinates(
                self.lonlat_crs, crs_string,
                dfraw['xlong'].values, dfraw['ylat'].values)
            dfraw = dfraw.assign(x=xlocs, y=ylocs)
        else:
            self._xcol, self._ycol = 'xlong', 'ylat'

        xbool = dfraw[self._xcol].between(bounds[0], bounds[2],
                                          inclusive='both')
        ybool = dfraw[self._ycol].between(bounds[1], bounds[3],
                                          inclusive='both')
        hhbool = dfraw['t_hh'].between(min_hubheight, 10000.,
                                       inclusive='left')
        self.dframe = dfraw.loc[xbool & ybool & hhbool, :]
        if out_fpath is not None:
            try:
                self.dframe.to_csv(out_fpath)
            except OSError as exc:
                print(f'TurbinesUSWTB: could not save {out_fpath}: {exc}')
        if print_verbose:
            self.print_details()

    def get_locations(self):
        xy = self.dframe.loc[:, [self._xcol, self._ycol]].values
        return xy[:, 0], xy[:, 1]

    def get_locations_for_this_project(self, pname: str):
        sel = self.dframe['p_name'] == pname
        return (self.dframe.loc[sel, self._xcol].values,
                self.dframe.loc[sel, self._ycol].values)

    def get_project_names(self):
        return self.dframe['p_name'].unique()

    def print_details(self):
        """Formatted summary (ssrs/turbines.py:97-121)."""
        if self.dframe is None or self.dframe.shape[0] == 0:
            print('TurbinesUSWTB: No wind turbines found within the '
                  'bounds!')
            return
        df = self.dframe
        print(f'Number of projects: {df.p_name.nunique()}')
        print(f'Number of turbines: {df.shape[0]}')
        print(f'Hub height (min,median,max): {df.t_hh.min()}, '
              f'{df.t_hh.median()}, {df.t_hh.max()}')
        print(f'Rotor Dia (min,median,max): {df.t_rd.min()}, '
              f'{df.t_rd.median()}, {df.t_rd.max()}')
        print(f'    {"Project":<26}{"State":<6}{"Year":<6}'
              f'{"Count":<6}{"Hub_Hght":<10}{"Rotor_Dia":<10}')
        pnames = df.sort_values(by='t_rd', ascending=False)['p_name']\
            .unique()
        for i, wfname in enumerate(pnames):
            sel = df['p_name'] == wfname
            print(f'{str(i + 1) + ".":<4}{wfname[:24]:<26}'
                  f'{df.loc[sel, "t_state"].iloc[0]:<6}'
                  f'{int(df.loc[sel, "p_year"].iloc[0]):<6}'
                  f'{df[sel].shape[0]:<6}'
                  f'{df.loc[sel, "t_hh"].median():<10}'
                  f'{df.loc[sel, "t_rd"].median():<10}')
