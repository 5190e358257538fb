"""Geometry folder management.

Capability parity: reference ``abstract_command.py:25-42``
(``ensure_geometry``) — if no ``./Geometry`` folder exists, download
``https://addbiomechanics.org/resources/Geometry.zip`` and unzip; return
the absolute path ending in '/'. Uses urllib instead of shelling out to
wget (the reference used ``os.system``), and degrades gracefully in
air-gapped environments (geometry only matters for mesh rendering).
"""

from __future__ import annotations

import logging
import os
import zipfile

logger = logging.getLogger(__name__)

GEOMETRY_URL = 'https://addbiomechanics.org/resources/Geometry.zip'


def ensure_geometry(geometry: str) -> str:
    if not geometry:
        if os.path.isdir('./Geometry'):
            geometry = './Geometry'
        else:
            try:
                import urllib.request
                logger.info('downloading %s', GEOMETRY_URL)
                urllib.request.urlretrieve(GEOMETRY_URL, 'Geometry.zip')
                with zipfile.ZipFile('Geometry.zip') as z:
                    z.extractall('.')
                os.remove('Geometry.zip')
                geometry = './Geometry'
            except Exception as e:  # zero-egress / offline environments
                logger.warning('could not download Geometry (%s); mesh '
                               'rendering will be unavailable', e)
                os.makedirs('./Geometry', exist_ok=True)
                geometry = './Geometry'
    geometry = os.path.abspath(geometry)
    if not geometry.endswith('/'):
        geometry += '/'
    return geometry
