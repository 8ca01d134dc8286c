"""The fixed CDF 9/7 ladder: no conv or product of its own (its lifting
steps are elementwise). Its output carries no gradient, so the first layer
of each subband's autoencoder takes no dx."""


def layers(cfg, c, b, h, w):
    levels = cfg["dwtlevels"]
    subbands = [(3 * c, b * (h >> (lvl + 1)) * (w >> (lvl + 1)), False)
                for lvl in range(levels)]
    subbands.append((c, b * (h >> levels) * (w >> levels), False))
    return [], subbands
