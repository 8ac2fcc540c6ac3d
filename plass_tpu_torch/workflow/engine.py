"""Resumable step-DAG workflow engine.

Replaces the reference's embedded POSIX-sh scripts (data/assemble.sh etc.)
while keeping their operational contract (data/assemble.sh:14-16,88-151):

 - every step materializes record DBs in the tmp dir
 - a step is skipped when its ``<name>.done`` sentinel exists; its outputs
   are loaded from disk instead (crash -> re-run resumes at the failed step)
 - tmp dirs are content-addressed by a parameter hash with a ``latest``
   symlink (FileUtil::createTemporaryDirectory, Assembler.cpp:72-77)
 - superseded iteration outputs can be deleted incrementally
   (--delete-tmp-inc, deleteIncremental in assemble.sh:8-12)
"""
import hashlib
import json
import os
import shutil
import time

from ..data import seqdb
from ..utils.log import logger


def create_tmp_dir(base, params_fingerprint, reuse_latest=False):
    """Param-hash-named tmp subdir + 'latest' symlink."""
    os.makedirs(base, exist_ok=True)
    h = hashlib.sha1(params_fingerprint.encode()).hexdigest()[:16]
    if reuse_latest and os.path.islink(os.path.join(base, "latest")):
        h = os.path.basename(os.readlink(os.path.join(base, "latest")))
    path = os.path.join(base, h)
    os.makedirs(path, exist_ok=True)
    link = os.path.join(base, "latest")
    try:
        if os.path.islink(link):
            os.unlink(link)
        os.symlink(h, link)
    except OSError:
        pass
    return path


def fingerprint(obj):
    """Stable fingerprint of a parameter dict + input paths."""
    return json.dumps(obj, sort_keys=True, default=str)


class Workflow:
    def __init__(self, tmp_dir, remove_tmp=False, delete_tmp_inc=False):
        self.tmp = tmp_dir
        self.remove_tmp = remove_tmp
        self.delete_tmp_inc = delete_tmp_inc
        self._timings = {}

    def path(self, name):
        return os.path.join(self.tmp, name)

    def done_file(self, name):
        return self.path(name) + ".done"

    def step(self, name, fn, outputs=(), force=False):
        """Run fn() -> dict{output_name: SeqDB} unless the sentinel exists.

        On skip, reloads the named outputs from the tmp dir. fn may also
        return None if it persists its own outputs.
        """
        sentinel = self.done_file(name)
        if not force and os.path.exists(sentinel):
            logger.info("skipping %s (already done)", name)
            return {o: seqdb.SeqDB.open(self.path(o)) for o in outputs}
        t0 = time.time()
        logger.info("step %s", name)
        result = fn()
        if result:
            for oname, db in result.items():
                db.save(self.path(oname))
        with open(sentinel, "w") as f:
            f.write("done\n")
        self._timings[name] = time.time() - t0
        logger.info("step %s done in %.2fs", name, self._timings[name])
        return result

    def delete_incremental(self, name):
        if not self.delete_tmp_inc or name is None:
            return
        for suffix in ("", ".index", ".dbtype"):
            p = self.path(name) + suffix
            if os.path.exists(p):
                os.unlink(p)

    def cleanup(self):
        if self.remove_tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)

    @property
    def timings(self):
        return dict(self._timings)
