"""eBird region/atlas-square species filtering.

Host logic ported from reference src/analyse.py:178-364: map (lat, lng) to an
observed-species list via atlas squares (binary search over longitude-ordered
squares, neighbour merging, sparse-data fallback), a region bounding box, or
the NZ-wide default; then drop predictions whose ebird ids were never
observed there, re-adding a generic "bird" when every specific label got
filtered.

Data files live in the package's data/ dir (the reference reads them from
./src relative to CWD); both degrade gracefully when absent
(reference :308-310, 329-348).
"""

import json
import logging
from pathlib import Path

DATA_DIR = Path(__file__).resolve().parent.parent / "data"
SPECIES_FILE = DATA_DIR / "ebird_species.json"
SPECIES_SQUARE_FILE = DATA_DIR / "ebird_species_per_square.json"


def find_square(squares, lng, lat):
    """Binary search on lng then scan for lat
    (reference: src/analyse.py:244-283)."""
    high = len(squares)
    low = 0
    found = None
    while high >= low:
        mid = (high + low) // 2
        square = squares[mid]
        bounds = square["bounds"]
        if bounds[0] <= lng and bounds[2] >= lng:
            found = mid
            break
        if bounds[2] < lng:
            low = mid + 1
        else:
            high = mid - 1
    if found is None:
        logging.error("Could not find species square for %s, %s", lng, lat)
        return None
    decrement = False
    while True:
        if mid < 0:
            return None
        if mid < len(squares):
            square = squares[mid]
            bounds = square["bounds"]
        if mid > len(squares) or bounds[0] > lng:
            if decrement:
                return None
            decrement = True
            mid = found - 1
            continue
        if bounds[1] <= lat and bounds[3] >= lat:
            return square
        if decrement:
            mid -= 1
        else:
            mid += 1


def merge_neighbours(square, species_meta):
    """Accumulate neighbour squares' per-month counts
    (reference: src/analyse.py:286-299)."""
    species_per_month = square["species_per_month"]
    for neighbour in square["neighbours_i"]:
        neighbour_species = species_meta[neighbour]["species_per_month"]
        for species, month_data in neighbour_species.items():
            if species not in species_per_month:
                species_per_month[species] = month_data.copy()
                continue
            for m, c in month_data.items():
                species_per_month[species][m] += c
    return species_per_month


def species_by_location(rec_metadata, species_file=None, species_square_file=None):
    """(species_list, region_code) for a recording's location
    (reference: src/analyse.py:302-364)."""
    species_file = Path(species_file or SPECIES_FILE)
    species_square_file = Path(species_square_file or SPECIES_SQUARE_FILE)
    if species_file.exists():
        with species_file.open("r") as f:
            species_data = json.load(f)
    else:
        logging.info("No species file")
        return None, None
    location_data = rec_metadata.get("location")
    species_list = set()
    region_code = None
    if location_data is None:
        region_code = "NZ"
        logging.info("No location data assume nz species")
        for species_info in species_data.values():
            region_info = species_info["region"]["info"]
            parent_info = region_info.get("parent")
            if (
                region_info["type"] == "country" and region_info["code"] == region_code
            ) or (parent_info is not None and parent_info["code"] == region_code):
                species_list.update(species_info["species"])
        species_list = list(species_list)
    else:
        lat = location_data.get("lat")
        lng = location_data.get("lng")
        if species_square_file.exists():
            with species_square_file.open("r") as f:
                species_square_data = json.load(f)
            square = find_square(species_square_data, lng, lat)
            if square is not None:
                species_per_month = merge_neighbours(square, species_square_data)
                total = 0
                for month in species_per_month.values():
                    total += sum(month.values())
                if total < 30 and len(species_per_month) > 3:
                    logging.info(
                        "Not using atlas square filtering as data is incomplete,"
                        " falling back to region"
                    )
                else:
                    species_list = list(species_per_month.keys())
                    region_code = square["region_code"]
                    logging.info("Found species list of %s", species_list)
                    return species_list, region_code

        for code, species_info in species_data.items():
            region_bounds = species_info["region"]["info"]["bounds"]
            if (
                lng >= region_bounds["minX"]
                and lng <= region_bounds["maxX"]
                and lat >= region_bounds["minY"]
                and lat <= region_bounds["maxY"]
            ):
                species_list = species_info["species"]
                region_code = code
                logging.info("Match lat %s lng %s to region %s ", lat, lng, code)
                break
    return species_list, region_code


def filter_by_location(meta_data, tracks, species_file=None, species_square_file=None):
    """Mark out-of-region predictions filtered; add a generic "bird" when all
    specific birds were dropped (reference: src/analyse.py:178-241; the
    raw_prediction branch there is unreachable because raw predictions only
    exist when the prediction list is empty, which the guard skips)."""
    observed_species, region_code = species_by_location(
        meta_data, species_file, species_square_file
    )
    if region_code is None:
        return
    logging.debug(
        "Matching to region code %s species list %s", region_code, observed_species
    )
    for track in tracks:
        for model_result in track.results:
            if len(model_result.predictions) == 0:
                continue
            filtered_bird = False
            for prediction in model_result.predictions:
                if prediction.ebird_id is None or any(
                    [
                        ebird
                        for ebird in prediction.ebird_id
                        if ebird in observed_species
                    ]
                ):
                    pass
                else:
                    filtered_bird = True
                    prediction.filtered = True
                    logging.info(
                        "Region filtering %s ebird %s",
                        prediction.what,
                        prediction.ebird_id,
                    )
            if filtered_bird:
                has_generic_bird = any(
                    [p for p in model_result.predictions if p.what == "bird"]
                )
                if not has_generic_bird:
                    logging.info("Adding bird as specific bird labels were filtered")
                    confidence = max(
                        [p.confidence for p in model_result.predictions if p.filtered]
                    )
                    threshold_used = max(
                        [
                            p.threshold_used
                            for p in model_result.predictions
                            if p.threshold_used
                        ]
                    )
                    model_result.add_prediction(
                        "bird",
                        confidence,
                        None,
                        threshold_used,
                        normalize_confidence=False,
                    )
