# Port-owned copy of hyperres/io/xml_sidecar.py, verbatim apart from its imports.
"""XML sidecar writer for ENVI products — schema parity with the
reference's ``_write_xml_sidecar`` (EMIT_data/emit_proj.py:137-210)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple
from xml.dom import minidom
from xml.etree import ElementTree as ET


def write_xml_sidecar(
    out_bin_path: str,
    *,
    product: str,
    epsg_str: str,
    crs_wkt: Optional[str],
    pixel_size: Optional[Tuple[float, float]],
    shape: Sequence[int],
    start_time_utc: str,
    end_time_utc: str,
    bbox_lonlat: List[List[float]],
    wavelengths: Optional[Sequence[float]] = None,
    fwhm: Optional[Sequence[float]] = None,
    band_names: Optional[Sequence[str]] = None,
    description: Optional[str] = None,
) -> str:
    lines, samples = int(shape[0]), int(shape[1])
    bands = (int(shape[2]) if len(shape) == 3
             else (len(band_names) if band_names else 1))

    root = ET.Element("EMITProduct")
    ET.SubElement(root, "ProductType").text = product
    if description:
        ET.SubElement(root, "Description").text = description

    t = ET.SubElement(root, "AcquisitionTime")
    ET.SubElement(t, "StartUTC").text = start_time_utc
    ET.SubElement(t, "EndUTC").text = end_time_utc

    g = ET.SubElement(root, "Geometry")
    ET.SubElement(g, "EPSG").text = epsg_str
    if crs_wkt:
        ET.SubElement(g, "CRS_WKT").text = crs_wkt
    if pixel_size:
        ps = ET.SubElement(g, "PixelSize")
        ET.SubElement(ps, "X").text = f"{float(pixel_size[0]):.10g}"
        ET.SubElement(ps, "Y").text = f"{float(pixel_size[1]):.10g}"

    bb = ET.SubElement(root, "BoundingBoxLonLat")
    for i, (lon, lat) in enumerate(bbox_lonlat, start=1):
        c = ET.SubElement(bb, f"Corner{i}")
        ET.SubElement(c, "Lon").text = f"{float(lon):.10g}"
        ET.SubElement(c, "Lat").text = f"{float(lat):.10g}"

    s = ET.SubElement(root, "RasterShape")
    ET.SubElement(s, "Lines").text = str(lines)
    ET.SubElement(s, "Samples").text = str(samples)
    ET.SubElement(s, "Bands").text = str(bands)

    if wavelengths is not None or fwhm is not None or band_names:
        spec = ET.SubElement(root, "Spectral")
        if wavelengths is not None:
            w = ET.SubElement(spec, "Wavelengths")
            w.set("units", "nanometers")
            for val in wavelengths:
                ET.SubElement(w, "Wavelength").text = f"{float(val):.10g}"
        if fwhm is not None:
            f = ET.SubElement(spec, "FWHM")
            f.set("units", "nanometers")
            for val in fwhm:
                ET.SubElement(f, "Value").text = f"{float(val):.10g}"
        if band_names:
            bn = ET.SubElement(spec, "BandNames")
            for name in band_names:
                ET.SubElement(bn, "Band").text = str(name)

    out_xml = os.path.splitext(str(out_bin_path))[0] + ".xml"
    pretty = minidom.parseString(ET.tostring(root)).toprettyxml(indent="  ")
    with open(out_xml, "w") as fh:
        fh.write(pretty)
    return out_xml
