"""Polite serial scraper for the tartan-register image renders.

Counterpart of ``tartangan_tpu/scraper.py`` (reference
tartangan/scraper.py:16-97), with the same CLI and state files: a shuffled
id list, resumable JSON state and error files saved every
``--save-state-freq`` downloads, a sleep between requests, and each id's
image bytes in ``OUTPUT/<id>.jpg``. It fetches with the standard library's
``urllib.request`` where the JAX package uses ``requests``, and keeps its
checks and error strings: a status other than 200 is ``status <code>``, a
``Content-Type`` that is not an image is ``not an image``, any other
failure its message.

Usage: python -m tartangan_torch.scraper OUTPUT [--url-template T]
       [--max-id N] [--size S] [--sleep SEC] [--state F] [--errors F]
       [--save-state-freq N]
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time
import urllib.error
import urllib.request

from .utils.fs import maybe_makedirs

DEFAULT_URL_TEMPLATE = (
    "https://www.tartanregister.gov.uk/IISRenderer/Render.ashx"
    "?id={page_id}&width={width}&height={height}"
)


def load_state(filename):
    if not os.path.exists(filename):
        return None
    with open(filename, "r") as infile:
        return json.load(infile)


def save_state(state, filename):
    with open(filename, "w") as outfile:
        json.dump(state, outfile)


def download_image_url(url, filename, timeout=30):
    """Download one image; returns an error string or None."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                return f"status {resp.status}"
            if not resp.headers.get("Content-Type", "").startswith("image"):
                return "not an image"
            content = resp.read()
        with open(filename, "wb") as f:
            f.write(content)
    except urllib.error.HTTPError as e:
        return f"status {e.code}"
    except Exception as e:  # noqa: BLE001 - recorded in the errors file
        return str(e)
    return None


def scrape_tartans(args):
    """Slowly, serially download images so as not to wear out our welcome."""
    maybe_makedirs(args.output_path, exist_ok=True)
    print("Scraping tartans")
    ids_to_scrape = load_state(args.state)
    if ids_to_scrape is None:
        ids_to_scrape = list(range(1, args.max_id))
        random.shuffle(ids_to_scrape)
        errors = []
    else:
        errors = load_state(args.errors) or []
    num_processed = 0
    while ids_to_scrape:
        page_id = ids_to_scrape.pop()
        url = args.url_template.format(
            page_id=page_id, width=args.size, height=args.size)
        print(url)
        filename = os.path.join(args.output_path, f"{page_id}.jpg")
        error = download_image_url(url, filename)
        if error:
            errors.append([page_id, error])
            print(error)
        num_processed += 1
        if num_processed % args.save_state_freq == 0:
            save_state(ids_to_scrape, args.state)
            save_state(errors, args.errors)
        time.sleep(args.sleep)  # we're decent people


def main(argv=None):
    p = argparse.ArgumentParser(description="Scrape tartan images.")
    p.add_argument("output_path")
    p.add_argument("--url-template", default=DEFAULT_URL_TEMPLATE)
    p.add_argument("--max-id", type=int, default=12000)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--sleep", type=float, default=2.0)
    p.add_argument("--state", default="scraper_state.json")
    p.add_argument("--errors", default="scraper_errors.json")
    p.add_argument("--save-state-freq", type=int, default=10)
    args = p.parse_args(argv)
    scrape_tartans(args)


if __name__ == "__main__":
    main()
