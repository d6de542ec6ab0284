"""CGS physical constants (mirror of
grackle: src/python/pygrackle/utilities/physical_constants.py)."""

mass_hydrogen_cgs = 1.67262171e-24
mass_electron_cgs = 9.10938215e-28
amu_cgs = 1.660538921e-24

boltzmann_constant_cgs = 1.3806504e-16
gravitational_constant_cgs = 6.67428e-8
planck_constant_cgs = 6.62606896e-27
speed_of_light_cgs = 2.99792458e10
stefan_boltzmann_constant_cgs = 5.670373e-5

rho_crit_g_cm3_h2 = 1.8788e-29

sec_per_Gyr = 3.1556952e16
sec_per_Myr = 3.1556952e13
sec_per_year = 3.1556952e7
sec_per_day = 8.64e4
sec_per_hour = 3600.0
sec_per_min = 60.0

cm_per_mpc = 3.0857e24
cm_per_kpc = 3.0857e21
cm_per_pc = 3.0857e18
cm_per_km = 1.0e5
km_per_pc = 3.0857e13
km_per_cm = 1.0e-5
pc_per_km = 3.24077929e-14
pc_per_cm = 3.24077929e-19
