"""``dataset.movielens`` (counterpart of ``paddle_tpu/dataset/movielens.py``)
— ML-1M ratings readers over a local zip."""
from __future__ import annotations

import os
import re
import zipfile

from . import common

__all__ = ["train", "test", "get_movie_title_dict", "max_movie_id",
           "max_user_id", "age_table", "max_job_id", "movie_categories",
           "user_info", "movie_info", "MovieInfo", "UserInfo"]

age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index, [CATEGORIES_DICT[c] for c in self.categories],
                [TITLE_DICT[w.lower()] for w in self.title.split()]]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


MOVIE_INFO = None
MOVIE_TITLE_DICT = None
CATEGORIES_DICT = None
TITLE_DICT = None
USER_INFO = None
RATINGS = None


def _zip_path():
    return os.path.join(common.DATA_HOME, "movielens", "ml-1m.zip")


def _load():
    global MOVIE_INFO, CATEGORIES_DICT, TITLE_DICT, USER_INFO, RATINGS
    if MOVIE_INFO is not None:
        return
    path = _zip_path()
    if not os.path.exists(path):
        raise RuntimeError(
            f"place ml-1m.zip at {path} (nothing is fetched)")
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    MOVIE_INFO = {}
    categories = set()
    titles = set()
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = line.decode("latin-1").strip().split("::")
                cat_list = cats.split("|")
                categories.update(cat_list)
                m = pattern.match(title)
                title_clean = m.group(1).strip() if m else title
                titles.update(w.lower() for w in title_clean.split())
                MOVIE_INFO[int(mid)] = MovieInfo(mid, cat_list, title_clean)
        CATEGORIES_DICT = {c: i for i, c in enumerate(sorted(categories))}
        TITLE_DICT = {w: i for i, w in enumerate(sorted(titles))}
        USER_INFO = {}
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _ = \
                    line.decode("latin-1").strip().split("::")
                USER_INFO[int(uid)] = UserInfo(uid, gender, age, job)
        RATINGS = []
        with z.open("ml-1m/ratings.dat") as f:
            for line in f:
                uid, mid, rating, _ = \
                    line.decode("latin-1").strip().split("::")
                RATINGS.append((int(uid), int(mid), float(rating)))


def _reader(is_test, test_ratio=0.1):
    def reader():
        _load()
        for i, (uid, mid, rating) in enumerate(RATINGS):
            in_test = (i % int(1 / test_ratio)) == 0
            if in_test != is_test:
                continue
            usr = USER_INFO[uid]
            mov = MOVIE_INFO[mid]
            yield usr.value() + mov.value() + [[rating]]

    return reader


def train():
    return _reader(False)


def test():
    return _reader(True)


def get_movie_title_dict():
    _load()
    return TITLE_DICT


def max_movie_id():
    _load()
    return max(MOVIE_INFO)


def max_user_id():
    _load()
    return max(USER_INFO)


def max_job_id():
    _load()
    return max(u.job_id for u in USER_INFO.values())


def movie_categories():
    _load()
    return CATEGORIES_DICT


def user_info():
    _load()
    return USER_INFO


def movie_info():
    _load()
    return MOVIE_INFO
