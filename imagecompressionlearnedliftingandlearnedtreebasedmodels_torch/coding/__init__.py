"""The real bitstream: host C++ rANS and context walkers (built at first
use), the wavefront coder of the ZTsep model and the codec coder."""
